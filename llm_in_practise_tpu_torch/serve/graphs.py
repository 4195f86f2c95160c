"""The decode block, the fused mixed step and the speculative round as one
CUDA graph replay each.

The JAX engine runs each of these as one compiled XLA program: one
dispatch, whatever the number of kernels in it. The port's counterpart is
a CUDA graph. :class:`StepGraphs` holds the static input buffers of the
step paths; each call copies the engine's host arrays into them and then,
on the card, replays the graph of its variant ``(kind, n, all_greedy,
width)``, or on the CPU runs the same body eagerly:

- ``"decode"``: :func:`~.mixed_step.decode_scan` over the contiguous
  cache;
- ``"mixed"``: the fused step of :func:`~.mixed_step.make_mixed_step`;
- ``"pdecode"`` / ``"pmixed"``: the same bodies in the paged layout,
  between a gather of every slot's pages into a ``width``-wide view and
  the scatter of each row's fresh window back into the pool
  (:mod:`.paged_kv`). ``width`` is the view's power-of-two bucket (the
  JAX engine compiles one program per bucket); the contiguous kinds have
  ``width`` None;
- ``"spec"`` / ``"pspec"``: the fused speculative round
  (:func:`~.mixed_step.spec_verify_block`, greedy only) over the
  contiguous cache, or between a gather and a scatter of a
  ``k + 1 + m``-row window per slot in the paged layout. ``n`` is the
  extension's ``m``; the round's ``out``, ``n_acc`` and ``extra`` come
  back as one ``(slots, k + 2 + m)`` tensor, read in one copy;
- ``"droll"``: the draft model's catch-up and roll
  (:func:`~.mixed_step.draft_roll`) over the draft's own contiguous
  cache; ``n`` is ``k`` and ``width`` the catch-up window ``W``;
- the grammar-masked twins (structured output, :mod:`.constrain`):
  ``"mdecode"`` / ``"pmdecode"`` and ``"mmixed"`` / ``"pmmixed"`` at
  ``n`` 1 read a static f32 ``gmask`` (slots, vocab) buffer, and
  ``"mspec"`` / ``"pmspec"`` at ``m`` 0 a ``gmasks`` (slots, k + 1,
  vocab) buffer. They are kinds of their own, as the JAX engine compiles
  separate masked programs: an engine that never sees a constraint
  captures none of them and allocates no mask buffer. The engine writes
  each mask's rows in place in a pinned host stage
  (:meth:`StepGraphs.mask_stage`), copied to the buffer before the
  step;
- the adapter twins (batched multi-LoRA, :mod:`.multi_lora`): every kind
  but ``"droll"`` (the draft runs base) has one, its kind prefixed with
  ``"l"`` (``"ldecode"``, ``"lpmspec"``, ...), whose body runs under a
  LoRA context over the registry's banks and static ``(slots,)`` int64
  index buffers, one per rank bucket, filled in :meth:`StepGraphs.run`
  like the other inputs. An engine without a registry, or whose rows are
  all base, captures none of them and allocates no index buffer. A
  captured twin reads each bank at its address: when the registry's
  ``generation`` moves (a bucket made, grown or given a target, which
  replaces its tensors) every twin is dropped and recaptured at its next
  use (``lora_recaptures``).

For the decode kinds ``n`` is ``decode_steps`` or a power of two below
it, as :func:`~.mixed_step.plan_decode_block` plans.

- **First use of a variant** runs its body eagerly on the card (that run
  is the step's result; it also builds each kernel, whose nvcc must not
  run inside a capture, and fills the launchers' once-per-variant
  caches), then captures it. A capture that fails raises with the
  variant's key; nothing falls back to the eager body.
- **Stable pointers.** The kernels' TMA descriptors are encoded on the
  host at capture and replayed as they are, so every tensor a graph reads
  keeps its address: the weights, the engine's KV cache or page pool
  (updated in place), the static buffers here (the paged kinds' gather
  and scatter indices are static buffers too, one set per width and
  window), and the activations and the paged view in the graphs' one
  shared memory pool.
- **Sampling** inside a graph cannot read the device from the host or
  draw from a generator: the variant's ``all_greedy`` is decided on the
  host, and a non-greedy block reads uniform noise that
  :meth:`StepGraphs.run` fills from the engine's generator before the
  replay (one launch into a ``(decode_steps, slots, vocab)`` f32 buffer).
- **Launch counts.** The kernel wrappers count in Python, which a replay
  skips: each capture's counter delta is recorded
  (:mod:`~llm_in_practise_tpu_torch.ops.launch_count`) and added on every
  replay.
- **No garbage collection inside a capture.** Python's cyclic collector
  is paused while a capture is open: collecting an unreachable engine's
  graphs on the capturing thread invalidates the capture.
- **One capture at a time in the process.** :data:`CAPTURE_LOCK` is held
  across each capture. Every other engine's step (``InferenceEngine.step``)
  and the handoff and session publishers' device-to-host copies hold it
  shared (:meth:`CaptureLock.work`), so they wait while a capture on
  another thread is in flight, and a capture waits for their work in
  flight to end. With one capturing engine in the process nothing waits.

The chunked-prefill paths outside the fused step (the batched chunk and
the single-slot chunk), the one-shot prefill and the draft's catch-up
chunks past its window stay eager: prefill-sized forwards, as the JAX
package compiles its prefill programs apart from the decode programs.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref

import numpy as np
import torch

from llm_in_practise_tpu_torch.ops import launch_count
from llm_in_practise_tpu_torch.serve.mixed_step import (
    decode_scan,
    draft_roll,
    make_mixed_step,
    pin_index,
    spec_verify_block,
)
from llm_in_practise_tpu_torch.serve.multi_lora import lora_context
from llm_in_practise_tpu_torch.serve.paged_kv import (
    gather_view,
    scatter_window,
)

# index arrays of the paged kinds: gather (slots x width), and the view
# positions and pool rows of the write-back window (slots x window)
PAGED_INDEX = ("gidx", "vidx", "sidx")
PAGED_KINDS = ("pdecode", "pmixed", "pspec", "pmdecode", "pmmixed",
               "pmspec")
# the grammar masks' static buffers
MASKS = ("gmask", "gmasks")
# the prefix of the adapter twin kinds
LORA = "l"


class CaptureLock:
    """A process-wide gate between CUDA graph captures and the rest of the
    process's device work: :meth:`capture` is exclusive, :meth:`work` is
    shared. A capture runs on a stream of its own in ``thread_local``
    mode, yet another engine's step or a publisher's copy on another
    thread can still invalidate it (``cudaErrorStreamCaptureInvalidated``
    seen with two replicas in one process), so the two never overlap.

    A thread's own work does not block its own capture (an engine
    captures inside its step), and a thread waiting to capture gives up
    its shared hold while it waits, so two engines that both capture
    inside their steps take turns instead of deadlocking. :meth:`work`
    takes nothing while at most one capturing engine is registered
    (:meth:`register`): one engine alone never waits."""

    def __init__(self):
        self._cv = threading.Condition()
        self._owner: int | None = None          # the capturing thread
        self._shared: dict[int, int] = {}       # thread -> work depth
        self._users = weakref.WeakSet()
        self.waits = 0          # work sections that waited on a capture
        self.captures = 0

    def register(self, user) -> None:
        """Count ``user`` (a capturing :class:`StepGraphs`) until it is
        collected."""
        with self._cv:
            self._users.add(user)

    @property
    def contended(self) -> bool:
        return len(self._users) > 1

    @contextlib.contextmanager
    def work(self):
        """Device work of one engine step or one publisher copy: waits
        while another thread captures."""
        if not self.contended:
            yield
            return
        me = threading.get_ident()
        with self._cv:
            # a nested section never waits: its thread already holds the
            # gate, and a capture waits for it
            if self._owner not in (None, me) and not self._shared.get(me):
                self.waits += 1
                while self._owner not in (None, me):
                    self._cv.wait()
            self._shared[me] = self._shared.get(me, 0) + 1
        try:
            yield
        finally:
            with self._cv:
                depth = self._shared.pop(me) - 1
                if depth:
                    self._shared[me] = depth
                self._cv.notify_all()

    @contextlib.contextmanager
    def capture(self):
        """One capture: waits for any other capture and for the other
        threads' work in flight, then holds the gate alone."""
        me = threading.get_ident()
        with self._cv:
            mine = self._shared.pop(me, 0)
            self._cv.notify_all()
            while self._owner is not None:
                self._cv.wait()
            self._owner = me
            while self._shared:
                self._cv.wait()
            self.captures += 1
        try:
            yield
        finally:
            with self._cv:
                self._owner = None
                if mine:
                    self._shared[me] = mine
                self._cv.notify_all()


CAPTURE_LOCK = CaptureLock()


class StepGraphs:
    """Static buffers of the engine's step paths, and with ``capture`` one
    CUDA graph per variant over ``cache`` (the contiguous layout) or
    ``paged`` (a :class:`~.paged_kv.PagedKV`). With ``spec_k`` the spec
    kinds have their buffers; with ``draft`` (a model) and its
    ``draft_cache`` the roll has its own, ``draft_window`` wide. Each
    capture's seconds go to ``compile_meter`` (a
    :class:`~..obs.prof.CompileMeter`) too."""

    def __init__(self, model, cache, *, max_slots: int, chunk: int | None,
                 decode_steps: int, capture: bool, paged=None,
                 spec_k: int | None = None, draft=None, draft_cache=None,
                 draft_window: int | None = None, compile_meter=None):
        dev = model.device
        self.model = model
        self.cache = cache
        self.paged = paged
        self.draft = draft
        self.draft_cache = draft_cache
        self.capture = capture
        # every capture's seconds also go here (llm_compile_*)
        self.compile_meter = compile_meter
        self.decode_steps = decode_steps
        self.vocab = model.config.vocab_size
        self._mixed = make_mixed_step(model)
        self._dev = dev
        self.spec_k = spec_k

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
        if spec_k is not None:
            self.inputs.update(spec_tokens=buf(b, spec_k + 1),
                               spec_mask=buf(b))
        if draft is not None:
            self.inputs.update(catchup=buf(b, draft_window),
                               roll_starts=buf(b), roll_lens=buf(b))
        self._index_bufs: dict[tuple, torch.Tensor] = {}  # (name, size)
        self.noise: torch.Tensor | None = None  # made at the first draw
        self.graphs: dict[tuple, tuple] = {}    # key -> (graph, out, delta)
        self.pool = None
        self.capture_s: dict[tuple, float] = {}
        self.pool_bytes = 0     # device memory the captures reserved
        self.replays = 0
        # grammar masks: device buffers and the host stages the engine
        # writes their rows in, made at the first masked step
        self.masks: dict[str, torch.Tensor] = {}
        self._mask_host: dict[str, torch.Tensor] = {}
        self._mask_stage: dict[str, np.ndarray] = {}
        # adapter twins: the banks of the registry generation the twins
        # were captured against, and each rank bucket's static index
        # buffer, made at the first adapter step
        self._lora_gen: int | None = None
        self._lora_banks: dict = {}
        self.lora_idx: dict[int, torch.Tensor] = {}
        self._lora_captured: set[tuple] = set()
        self.lora_recaptures = 0
        self.lora_invalidations = 0
        if capture:
            CAPTURE_LOCK.register(self)

    def _mask_buf(self, name: str) -> torch.Tensor:
        """The static device buffer of ``gmask`` (slots, vocab) or
        ``gmasks`` (slots, k + 1, vocab), made at first use."""
        t = self.masks.get(name)
        if t is None:
            b = self.inputs["tokens"].shape[0]
            shape = ((b, self.vocab) if name == "gmask"
                     else (b, self.spec_k + 1, self.vocab))
            with torch.inference_mode(False):
                t = torch.zeros(shape, dtype=torch.float32, device=self._dev)
                host = t
                if self._dev.type == "cuda":
                    host = torch.zeros(shape, dtype=torch.float32,
                                       pin_memory=True)
                    self._mask_host[name] = host
            self._mask_stage[name] = host.numpy()
            self.masks[name] = t
        return t

    def mask_stage(self, name: str) -> np.ndarray:
        """The host array the engine writes ``name``'s rows in, in place:
        on the card the pinned stage of its static buffer, on the CPU the
        buffer itself. It keeps its rows from one step to the next."""
        self._mask_buf(name)
        return self._mask_stage[name]

    def _stage_mask(self, name: str, a) -> None:
        """Bring ``name``'s static buffer up to the host mask ``a`` (its
        stage, or an array copied into the stage first). On the card the
        copy is asynchronous: the step's own read of its outputs orders
        the engine's next write of the stage after it."""
        stage = self.mask_stage(name)
        if a is not stage:
            stage[...] = a
        host = self._mask_host.get(name)
        if host is not None:
            self.masks[name].copy_(host, non_blocking=True)

    def _stage_lora(self, lora: dict) -> None:
        """Fill the index buffers from ``lora`` (the registry's dispatch
        arguments); on a new bank generation first drop every captured
        twin, which read the old banks."""
        if lora["generation"] != self._lora_gen:
            stale = [k for k in self.graphs if k[0].startswith(LORA)]
            for key in stale:
                del self.graphs[key]
            self.lora_invalidations += bool(stale)
            self._lora_gen = lora["generation"]
            self._lora_banks = lora["banks"]
            for rb in lora["idx"]:
                if rb not in self.lora_idx:
                    with torch.inference_mode(False):
                        self.lora_idx[rb] = torch.zeros(
                            self.inputs["tokens"].shape, dtype=torch.int64,
                            device=self._dev)
        for rb, rows in lora["idx"].items():
            self.lora_idx[rb].copy_(torch.from_numpy(rows))

    def _index_buf(self, name: str, size: int) -> torch.Tensor:
        """The static flat int64 buffer of a paged index array: one per
        (name, size), so every graph of that width or window reads the
        same address."""
        t = self._index_bufs.get((name, size))
        if t is None:
            with torch.inference_mode(False):
                t = torch.zeros((size,), dtype=torch.int64, device=self._dev)
            self._index_bufs[(name, size)] = t
        return t

    def run(self, kind: str, n: int, *, all_greedy: bool, generator,
            width: int | None = None, lora=None, **arrays) -> dict:
        """One step of ``kind`` over ``n`` decode tokens. ``arrays`` (numpy)
        go into the static buffers of the same names (the paged kinds'
        ``gidx``, ``vidx`` and ``sidx`` into their per-size buffers).
        ``gmask`` and ``gmasks`` (f32) go into the masks' static
        buffers. Returns the step's outputs: ``toks`` (slots, n), ``index``
        (slots,) and for the fused kinds ``chunk_last`` (slots, vocab);
        ``spec`` (slots, k + 2 + m) for the spec kinds; ``drafts``
        (slots, k) for the roll. On the card they are the graph's own
        tensors, valid until the next call. With ``lora`` (the registry's
        dispatch arguments) the adapter twin of ``kind`` runs."""
        if lora is not None:
            kind = LORA + kind
            self._stage_lora(lora)
        for name, a in arrays.items():
            if name in MASKS:
                self._stage_mask(name, a)
                continue
            flat = torch.from_numpy(a)
            if name in PAGED_INDEX:
                flat = flat.reshape(-1)
                self._index_buf(name, flat.numel()).copy_(flat)
            else:
                self.inputs[name].copy_(flat)
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
        window = arrays["sidx"].size if "sidx" in arrays else None
        key = (kind, n, all_greedy, width, window)
        if kind.removeprefix(LORA) in PAGED_KINDS:
            # the gather view this step materializes beside the pool
            self.paged.pulse_view(width)
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
        if key[0].startswith(LORA):
            ctx = {"idx": {rb: self.lora_idx[rb] for rb in self._lora_banks},
                   "banks": self._lora_banks}
            with lora_context(ctx):
                return self._body((key[0][len(LORA):],) + key[1:])
        kind, n, all_greedy, width, window = key
        x = self.inputs
        samp = dict(n=n, all_greedy=all_greedy,
                    noise=None if all_greedy else self.noise[:n])
        params = (x["temperature"], x["top_k"], x["top_p"], x["greedy"])
        rows = x["tokens"].shape[0]
        if kind == "droll":
            drafts, cache = draft_roll(self.draft, self.draft_cache,
                                       x["catchup"], x["roll_starts"],
                                       x["roll_lens"], k=n)
            return {"drafts": drafts, "index": cache[0]["index"]}
        if kind in PAGED_KINDS:
            g, cache = gather_view(
                self.paged, self._index_buf("gidx", rows * width), rows,
                x["starts"] if kind in ("pmixed", "pmmixed") else x["index"])
        else:
            cache = self.cache
        if kind in ("spec", "pspec", "mspec", "pmspec"):
            gm = ({} if kind in ("spec", "pspec")
                  else {"gmasks": self.masks["gmasks"]})
            out, n_acc, extra, cache = spec_verify_block(
                self.model, cache, x["spec_tokens"], x["index"],
                x["spec_mask"], m=n, **gm)
            out = {"spec": torch.cat([out, n_acc[:, None], extra], dim=1),
                   "index": cache[0]["index"]}
        elif kind in ("decode", "pdecode", "mdecode", "pmdecode"):
            gm = ({} if kind in ("decode", "pdecode")
                  else {"gmask": self.masks["gmask"]})
            toks, cache = decode_scan(
                self.model, pin_index(cache, x["index"]), x["tokens"],
                *params, **samp, **gm)
            out = {"toks": toks, "index": cache[0]["index"]}
        else:
            gm = ({} if kind in ("mixed", "pmixed")
                  else {"gmask": self.masks["gmask"]})
            chunk_last, toks, cache = self._mixed(
                cache, x["chunk_ids"], x["starts"], x["lens"],
                x["advance"], x["tokens"], *params, **samp, **gm)
            out = {"chunk_last": chunk_last, "toks": toks,
                   "index": cache[0]["index"]}
        if kind in PAGED_KINDS:
            scatter_window(self.paged, g, self._index_buf("vidx", window),
                           self._index_buf("sidx", window))
        return out

    def _capture(self, key: tuple) -> None:
        with CAPTURE_LOCK.capture():
            self._capture_locked(key)

    def _capture_locked(self, key: tuple) -> None:
        t0 = time.monotonic()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = launch_count.snapshot()
        graph = torch.cuda.CUDAGraph()
        # no cyclic garbage collection while the capture is open: a
        # collection inside the body, on this thread, would destroy an
        # unreachable engine's graphs, which is not permitted while a
        # stream captures and invalidates the capture
        # (cudaErrorStreamCaptureInvalidated after "operation not permitted
        # when stream is capturing (function reset)"). torch.cuda.graph
        # collects once before it begins the capture
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the HTTP threads may touch CUDA state (they do
            # not today); only this thread's calls must be capture-safe
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                out = self._body(key)
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of step variant {key} (kind, n, "
                f"all_greedy, width, window) failed: "
                f"{type(e).__name__}: {e}") from e
        finally:
            if gc_was_enabled:
                gc.enable()
            after = launch_count.snapshot()
            launch_count.restore(before)   # a capture launches nothing
        self.graphs[key] = (graph, out, launch_count.delta(before, after))
        self.pool_bytes += torch.cuda.memory_reserved() - reserved
        self.capture_s[key] = time.monotonic() - t0
        if self.compile_meter is not None:
            self.compile_meter.note(self.capture_s[key])
        if key[0].startswith(LORA):
            self.lora_recaptures += key in self._lora_captured
            self._lora_captured.add(key)
