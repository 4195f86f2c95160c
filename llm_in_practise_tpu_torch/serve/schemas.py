"""OpenAI chat-completions wire schemas, dependency-free.

Port of ``llm_in_practise_tpu/serve/schemas.py``. Validation errors map
to HTTP 422 as in the JAX package. The structured-output fields
(``response_format``, ``tools``, ``tool_choice``) are shape-checked here;
what a schema may say is :mod:`.constrain`'s to judge.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any


class ValidationError(ValueError):
    """Bad request payload: HTTP 422."""


@dataclasses.dataclass
class ChatMessage:
    role: str
    content: str

    VALID_ROLES = ("system", "user", "assistant", "tool")

    @classmethod
    def from_dict(cls, d: Any) -> "ChatMessage":
        if not isinstance(d, dict):
            raise ValidationError(
                f"message must be an object, got {type(d).__name__}")
        role, content = d.get("role"), d.get("content")
        if role not in cls.VALID_ROLES:
            raise ValidationError(f"invalid role {role!r}")
        if not isinstance(content, str):
            raise ValidationError("message content must be a string")
        return cls(role, content)


def _validate_response_format(rf: Any):
    """Shape-check OpenAI ``response_format`` (which schemas are
    supported is :mod:`.constrain`'s to judge)."""
    if rf is None:
        return None
    if not isinstance(rf, dict):
        raise ValidationError("'response_format' must be an object")
    rf_type = rf.get("type")
    if rf_type not in ("text", "json_object", "json_schema"):
        raise ValidationError(
            "response_format.type must be 'text', 'json_object', or "
            f"'json_schema', got {rf_type!r}")
    if rf_type == "json_schema":
        wrapper = rf.get("json_schema")
        if not isinstance(wrapper, dict) or not isinstance(
                wrapper.get("schema"), dict):
            raise ValidationError(
                "response_format.json_schema.schema must be an object")
    return rf


def _validate_tools(tools: Any, tool_choice: Any):
    """Shape-check OpenAI ``tools`` / ``tool_choice``."""
    if tools is not None:
        if not isinstance(tools, list):
            raise ValidationError("'tools' must be an array")
        for t in tools:
            if (not isinstance(t, dict) or t.get("type") != "function"
                    or not isinstance(t.get("function"), dict)
                    or not isinstance(t["function"].get("name"), str)):
                raise ValidationError(
                    "each tool must be {'type': 'function', 'function': "
                    "{'name': …, 'parameters': …}}")
    if tool_choice is None:
        return tools, None
    if isinstance(tool_choice, str):
        if tool_choice not in ("auto", "none", "required"):
            raise ValidationError(
                "tool_choice must be 'auto', 'none', 'required', or a "
                "function reference")
    elif isinstance(tool_choice, dict):
        if (tool_choice.get("type") != "function"
                or not isinstance(tool_choice.get("function"), dict)
                or not isinstance(
                    tool_choice["function"].get("name"), str)):
            raise ValidationError(
                "tool_choice object must be {'type': 'function', "
                "'function': {'name': …}}")
    else:
        raise ValidationError("tool_choice must be a string or object")
    if tool_choice not in ("auto", "none") and not tools:
        raise ValidationError(
            f"tool_choice {tool_choice!r} requires a non-empty 'tools'")
    return tools, tool_choice


@dataclasses.dataclass
class ChatCompletionRequest:
    """Request body of POST /v1/chat/completions, with the
    structured-output surface: ``response_format`` and ``tools`` /
    ``tool_choice``, enforced by grammar-compiled logit masks
    (:mod:`.constrain`)."""

    model: str
    messages: list[ChatMessage]
    max_tokens: int = 512
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    stream: bool = False
    response_format: dict | None = None
    tools: list | None = None
    tool_choice: Any = None

    @classmethod
    def from_dict(cls, d: Any) -> "ChatCompletionRequest":
        if not isinstance(d, dict):
            raise ValidationError("request body must be a JSON object")
        if not isinstance(d.get("model"), str) or not d["model"]:
            raise ValidationError("'model' is required")
        raw_msgs = d.get("messages")
        if not isinstance(raw_msgs, list) or not raw_msgs:
            raise ValidationError("'messages' must be a non-empty array")
        msgs = [ChatMessage.from_dict(m) for m in raw_msgs]

        def num(key, default, lo, hi, kind=float):
            v = d.get(key, default)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise ValidationError(f"'{key}' must be a number")
            v = kind(v)
            if not (lo <= v <= hi):
                raise ValidationError(f"'{key}' must be in [{lo}, {hi}]")
            return v

        tools, tool_choice = _validate_tools(
            d.get("tools"), d.get("tool_choice"))
        return cls(
            model=d["model"],
            messages=msgs,
            max_tokens=num("max_tokens", 512, 1, 1 << 20, int),
            temperature=num("temperature", 1.0, 0.0, 2.0),
            top_p=num("top_p", 1.0, 0.0, 1.0),
            top_k=num("top_k", 0, 0, 1 << 20, int),
            stream=bool(d.get("stream", False)),
            response_format=_validate_response_format(
                d.get("response_format")),
            tools=tools,
            tool_choice=tool_choice,
        )


@dataclasses.dataclass
class Usage:
    prompt_tokens: int
    completion_tokens: int

    def to_dict(self) -> dict:
        return {
            "prompt_tokens": self.prompt_tokens,
            "completion_tokens": self.completion_tokens,
            "total_tokens": self.prompt_tokens + self.completion_tokens,
        }


def completion_id() -> str:
    return "chatcmpl-" + uuid.uuid4().hex[:24]


def chat_completion_response(*, req_id: str, model: str, text: str,
                             finish_reason: str, usage: Usage,
                             tool_calls: list | None = None) -> dict:
    """``tool_calls`` (forced tool-choice requests): the parsed calls
    replace ``content`` and the finish reason becomes ``tool_calls``, as
    in the OpenAI wire shape."""
    message: dict = {"role": "assistant", "content": text}
    if tool_calls is not None:
        message = {"role": "assistant", "content": None,
                   "tool_calls": tool_calls}
        finish_reason = "tool_calls"
    return {
        "id": req_id,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": message,
            "finish_reason": finish_reason,
        }],
        "usage": usage.to_dict(),
    }


def tool_call_entry(name: str, arguments: str) -> dict:
    """One ``message.tool_calls[]`` entry (``arguments`` is the JSON
    text, per the OpenAI wire format)."""
    return {
        "id": "call_" + uuid.uuid4().hex[:24],
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


def chat_completion_chunk(*, req_id: str, model: str, delta: str | None,
                          finish_reason: str | None = None) -> dict:
    """One SSE chunk (``object: chat.completion.chunk``)."""
    d: dict = {}
    if delta is not None:
        d["content"] = delta
    if not d and finish_reason is None:
        d = {"role": "assistant"}
    return {
        "id": req_id,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0, "delta": d, "finish_reason": finish_reason}],
    }
