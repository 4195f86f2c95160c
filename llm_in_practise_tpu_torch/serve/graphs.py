"""The decode block and the fused mixed step as one CUDA graph replay each.

The JAX engine runs each of these as one compiled XLA program: one
dispatch, whatever the number of kernels in it. The port's counterpart is
a CUDA graph. :class:`StepGraphs` holds the static input buffers of both
step paths; each call copies the engine's host arrays into them and then,
on the card, replays the graph of its variant ``(kind, n, all_greedy)``
(``kind`` is ``"decode"`` or ``"mixed"``; ``n`` is ``decode_steps`` or a
power of two below it, as :func:`~.mixed_step.plan_decode_block` plans),
or on the CPU runs the same body (:func:`~.mixed_step.decode_scan`,
:func:`~.mixed_step.make_mixed_step`) eagerly.

- **First use of a variant** runs its body eagerly on the card (that run
  is the step's result; it also builds each kernel, whose nvcc must not
  run inside a capture, and fills the launchers' once-per-variant
  caches), then captures it. A capture that fails raises with the
  variant's key; nothing falls back to the eager body.
- **Stable pointers.** The kernels' TMA descriptors are encoded on the
  host at capture and replayed as they are, so every tensor a graph reads
  keeps its address: the weights, the engine's KV cache (updated in
  place), the static buffers here, and the activations in the graphs'
  one shared memory pool.
- **Sampling** inside a graph cannot read the device from the host or
  draw from a generator: the variant's ``all_greedy`` is decided on the
  host, and a non-greedy block reads uniform noise that
  :meth:`StepGraphs.run` fills from the engine's generator before the
  replay (one launch into a ``(decode_steps, slots, vocab)`` f32 buffer).
- **Launch counts.** The kernel wrappers count in Python, which a replay
  skips: each capture's counter delta is recorded
  (:mod:`~llm_in_practise_tpu_torch.ops.launch_count`) and added on every
  replay.

The chunked-prefill paths outside the fused step (the batched chunk and
the single-slot chunk) and the one-shot prefill stay eager: prefill-sized
forwards, as the JAX package compiles its prefill programs apart from the
decode programs.
"""

from __future__ import annotations

import time

import torch

from llm_in_practise_tpu_torch.ops import launch_count
from llm_in_practise_tpu_torch.serve.mixed_step import (
    decode_scan,
    make_mixed_step,
    pin_index,
)


class StepGraphs:
    """Static buffers of the engine's decode block and fused mixed step,
    and with ``capture`` one CUDA graph per variant over ``cache``."""

    def __init__(self, model, cache, *, max_slots: int, chunk: int | None,
                 decode_steps: int, capture: bool):
        dev = model.device
        self.model = model
        self.cache = cache
        self.capture = capture
        self.decode_steps = decode_steps
        self.vocab = model.config.vocab_size
        self._mixed = make_mixed_step(model)

        def buf(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        b = max_slots
        self.inputs = {"tokens": buf(b), "index": buf(b),
                       "temperature": buf(b, dtype=torch.float32),
                       "top_k": buf(b), "top_p": buf(b, dtype=torch.float32),
                       "greedy": buf(b, dtype=torch.bool)}
        if chunk is not None:
            self.inputs.update(chunk_ids=buf(b, chunk), starts=buf(b),
                               lens=buf(b), advance=buf(b))
        self.noise: torch.Tensor | None = None  # made at the first draw
        self.graphs: dict[tuple, tuple] = {}    # key -> (graph, out, delta)
        self.pool = None
        self.capture_s: dict[tuple, float] = {}
        self.pool_bytes = 0     # device memory the captures reserved
        self.replays = 0

    def run(self, kind: str, n: int, *, all_greedy: bool, generator,
            **arrays) -> dict:
        """One step of ``kind`` over ``n`` decode tokens. ``arrays`` (numpy)
        go into the static buffers of the same names. Returns the step's
        outputs, ``toks`` (slots, n), ``index`` (slots,) and for
        ``"mixed"`` ``chunk_last`` (slots, vocab): on the card they are
        the graph's own tensors, valid until the next call."""
        for name, a in arrays.items():
            self.inputs[name].copy_(torch.from_numpy(a))
        if not all_greedy:
            if self.noise is None:
                # a normal tensor, as the other buffers, even when the
                # first draw comes inside inference mode
                with torch.inference_mode(False):
                    self.noise = torch.empty(
                        (self.decode_steps, self.inputs["tokens"].shape[0],
                         self.vocab), dtype=torch.float32,
                        device=self.inputs["tokens"].device)
            self.noise[:n].uniform_(0.0, 1.0, generator=generator)
        key = (kind, n, all_greedy)
        if not self.capture:
            return self._body(key)
        entry = self.graphs.get(key)
        if entry is None:
            out = self._body(key)   # the warm-up is this step's result
            self._capture(key)
            return out
        graph, out, delta = entry
        graph.replay()
        launch_count.add(delta)
        self.replays += 1
        return out

    def _body(self, key: tuple) -> dict:
        kind, n, all_greedy = key
        x = self.inputs
        samp = dict(n=n, all_greedy=all_greedy,
                    noise=None if all_greedy else self.noise[:n])
        params = (x["temperature"], x["top_k"], x["top_p"], x["greedy"])
        if kind == "decode":
            toks, cache = decode_scan(
                self.model, pin_index(self.cache, x["index"]), x["tokens"],
                *params, **samp)
            return {"toks": toks, "index": cache[0]["index"]}
        chunk_last, toks, cache = self._mixed(
            self.cache, x["chunk_ids"], x["starts"], x["lens"],
            x["advance"], x["tokens"], *params, **samp)
        return {"chunk_last": chunk_last, "toks": toks,
                "index": cache[0]["index"]}

    def _capture(self, key: tuple) -> None:
        t0 = time.monotonic()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = launch_count.snapshot()
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: the HTTP threads may touch CUDA state (they do
            # not today); only this thread's calls must be capture-safe
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                out = self._body(key)
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of step variant {key} (kind, n, "
                f"all_greedy) failed: {type(e).__name__}: {e}") from e
        finally:
            after = launch_count.snapshot()
            launch_count.restore(before)   # a capture launches nothing
        self.graphs[key] = (graph, out, launch_count.delta(before, after))
        self.pool_bytes += torch.cuda.memory_reserved() - reserved
        self.capture_s[key] = time.monotonic() - t0
