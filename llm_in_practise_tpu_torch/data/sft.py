"""ChatML rendering (port of ``llm_in_practise_tpu/data/sft.py:28-64``).

Only the serving half is ported: the special tokens and the template.
"""

from __future__ import annotations

from collections.abc import Sequence

IM_START = "<|im_start|>"
IM_END = "<|im_end|>"


def render_chatml(messages: Sequence[dict]) -> str:
    """``<|im_start|>{role}\\n{content}<|im_end|>\\n`` per message, stripped."""
    text = ""
    for msg in messages:
        text += f"{IM_START}{msg['role']}\n{msg['content']}{IM_END}\n"
    return text.strip()
