"""The serving CLI's default for ``--speculative`` per replica role (port
of two names of ``llm_in_practise_tpu/serve/disagg.py``).

The rest of that module, the prefill/decode roles (``--role``) and the
KV handoff between them, is ROADMAP.md queue A item 5 and is not ported
yet; the port's CLI serves ``--role both`` only.
"""

from __future__ import annotations

#: ngram proposal length of a decode replica by default: decode is
#: bandwidth-bound, a decode replica never prefills by design, and the
#: fused spec round is lossless under greedy, so speculation is on there
#: unless the operator turns it off
DECODE_DEFAULT_SPEC_K = 4


def default_speculative_k(role: str, requested: int | None) -> int | None:
    """Resolve the serving CLI's ``--speculative`` value for ``role``: an
    explicit 0 turns speculation off, ``--role decode`` defaults it on
    (:data:`DECODE_DEFAULT_SPEC_K`, the ngram proposer), any positive
    value passes through, and other roles keep it opt-in."""
    if requested == 0:
        return None
    if requested is None and role == "decode":
        return DECODE_DEFAULT_SPEC_K
    return requested
