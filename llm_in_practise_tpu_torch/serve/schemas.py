"""OpenAI chat-completions wire schemas, dependency-free.

Port of ``llm_in_practise_tpu/serve/schemas.py``. Validation errors map
to HTTP 422 as in the JAX package. The structured-output fields
(``response_format`` other than ``{"type": "text"}``, ``tools``, a forcing
``tool_choice``) are not ported yet: they raise
:class:`UnsupportedFieldError`, which the server answers with HTTP 400.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any


class ValidationError(ValueError):
    """Bad request payload: HTTP 422."""


class UnsupportedFieldError(ValueError):
    """A request field this port does not serve yet: HTTP 400."""


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


def _reject_unported(d: dict) -> None:
    rf = d.get("response_format")
    if rf is not None and not (isinstance(rf, dict)
                               and rf.get("type") == "text"):
        raise UnsupportedFieldError(
            "'response_format' (structured output) is not supported by this "
            "server yet (ROADMAP.md queue A item 5)")
    if d.get("tools") is not None:
        raise UnsupportedFieldError(
            "'tools' (tool calling) is not supported by this server yet "
            "(ROADMAP.md queue A item 5)")
    if d.get("tool_choice") not in (None, "auto", "none"):
        raise UnsupportedFieldError(
            "'tool_choice' other than 'auto'/'none' is not supported by this "
            "server yet (ROADMAP.md queue A item 5)")


@dataclasses.dataclass
class ChatCompletionRequest:
    """Request body of POST /v1/chat/completions."""

    model: str
    messages: list[ChatMessage]
    max_tokens: int = 512
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    stream: bool = False

    @classmethod
    def from_dict(cls, d: Any) -> "ChatCompletionRequest":
        if not isinstance(d, dict):
            raise ValidationError("request body must be a JSON object")
        _reject_unported(d)
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

        return cls(
            model=d["model"],
            messages=msgs,
            max_tokens=num("max_tokens", 512, 1, 1 << 20, int),
            temperature=num("temperature", 1.0, 0.0, 2.0),
            top_p=num("top_p", 1.0, 0.0, 1.0),
            top_k=num("top_k", 0, 0, 1 << 20, int),
            stream=bool(d.get("stream", False)),
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
                             finish_reason: str, usage: Usage) -> dict:
    return {
        "id": req_id,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "finish_reason": finish_reason,
        }],
        "usage": usage.to_dict(),
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
