"""Step timing, throughput, rolling metrics, the serving meters and the
profiler trace context (port of ``llm_in_practise_tpu/obs/meter.py``).

- :class:`RollingMean`, :class:`Throughput`, :class:`EpochTimer`: the
  train loop's rolling loss, tokens/sec and wall clock.
- :class:`DispatchMeter`: engine dispatches per step and the per-phase
  MFU / HBM-bandwidth / tokens-per-dispatch gauges.
- :class:`HandoffMeter`: the decode replica's claim-side handoff counts.
- :class:`GoodputMeter` / :func:`register_goodput`: SLO goodput and the
  blame of a violated request's longest phase span.
- :func:`profile_trace`: a ``torch.profiler`` trace (CPU and CUDA
  activities) around a block, one at a time per process, written as a
  gzipped Chrome trace; :func:`exclusive_profile` is the same lock around
  a caller's own ``torch.profiler.profile``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

class RollingMean:
    """Rolling mean over the last ``window`` values (last-50 loss parity)."""

    def __init__(self, window: int = 50):
        self.values: collections.deque[float] = collections.deque(maxlen=window)

    def update(self, v: float) -> float:
        self.values.append(float(v))
        return self.mean

    @property
    def mean(self) -> float:
        return sum(self.values) / len(self.values) if self.values else 0.0


class Throughput:
    """Tokens/sec + step-time meter. Call :meth:`step` once per train step."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.steps = 0
        self.tokens = 0
        self.step_time = RollingMean(window=20)

    def step(self, n_tokens: int) -> None:
        now = time.perf_counter()
        self.step_time.update(now - self.last)
        self.last = now
        self.steps += 1
        self.tokens += int(n_tokens)

    @property
    def tokens_per_sec(self) -> float:
        elapsed = time.perf_counter() - self.t0
        return self.tokens / elapsed if elapsed > 0 else 0.0

    @property
    def mean_step_s(self) -> float:
        return self.step_time.mean


class _PhaseAcc:
    """Rolling per-dispatch accounting for one phase (prefill/decode).

    Updated by the engine thread only; the cached floats are what
    scraper threads read (iterating a deque cross-thread could race a
    concurrent append — same contract as ``DispatchMeter.per_step``)."""

    __slots__ = ("dispatches", "tokens_total", "seconds_total",
                 "_tokens_roll", "_mfu_roll", "_bw_roll",
                 "tokens_per_dispatch", "mfu", "hbm_bw_util")

    def __init__(self, window: int):
        self.dispatches = 0
        self.tokens_total = 0
        self.seconds_total = 0.0
        self._tokens_roll = RollingMean(window)
        self._mfu_roll = RollingMean(window)
        self._bw_roll = RollingMean(window)
        self.tokens_per_dispatch = 0.0
        self.mfu: float | None = None
        self.hbm_bw_util: float | None = None

    def update(self, *, tokens, duration_s, mfu, hbm_bw_util) -> None:
        self.dispatches += 1
        self.tokens_total += int(tokens)
        self.seconds_total += float(duration_s)
        self.tokens_per_dispatch = self._tokens_roll.update(tokens)
        if mfu is not None:
            self.mfu = self._mfu_roll.update(mfu)
        if hbm_bw_util is not None:
            self.hbm_bw_util = self._bw_roll.update(hbm_bw_util)

    def snapshot(self) -> dict:
        out = {
            "dispatches": self.dispatches,
            "tokens_total": self.tokens_total,
            "seconds_total": round(self.seconds_total, 6),
            "tokens_per_dispatch": round(self.tokens_per_dispatch, 3),
        }
        if self.mfu is not None:
            out["mfu"] = round(self.mfu, 6)
        if self.hbm_bw_util is not None:
            out["hbm_bw_util"] = round(self.hbm_bw_util, 6)
        return out


class DispatchMeter:
    """Per-step device-dispatch accounting for the serving engine.

    The number of engine dispatches per step (a CUDA graph replay, or an
    eager prefill forward) is what the step scheduler plans; this meter
    makes it assertable (tests) and scrapeable (/metrics): the engine
    calls :meth:`count` at each dispatch and brackets each ``step()``
    with :meth:`note_step`.

    Counts engine dispatches only: host-side eager ops (the
    activation-time sampling of a first token) are not dispatches the
    step scheduler plans.

    **Per-phase device attribution** (:meth:`note_phase`): the engine
    additionally reports each dispatch's phase (``prefill`` /
    ``decode``), token count, wall time, and — when it has an
    :class:`~llm_in_practise_tpu_torch.obs.cost.CostModel` — the dispatch's
    MFU and HBM-bandwidth utilization. ``/metrics`` renders the rolling
    means as ``llm_dispatch_mfu{phase=…}`` /
    ``llm_dispatch_hbm_bw_util{phase=…}`` /
    ``llm_dispatch_tokens_per_dispatch{phase=…}`` — the live
    compute-vs-bandwidth-bound dial (arxiv 2311.03687's per-phase
    runtime dissection, on the serving replica instead of in a paper).
    Durations are the card's time between a pair of CUDA events around
    the dispatch, clamped to the dispatch window's wall time (on the CPU,
    that wall time).
    """

    def __init__(self, window: int = 50):
        self.total = 0          # dispatches since engine construction
        self.steps = 0          # step() iterations observed
        self.last_step = 0      # dispatches in the most recent step
        self.per_step = RollingMean(window=window)
        self._mean = 0.0
        self._phase_window = window
        self.phases: dict[str, _PhaseAcc] = {}

    def count(self, n: int = 1) -> None:
        self.total += int(n)

    def note_phase(self, phase: str, *, tokens: int, duration_s: float,
                   mfu: float | None = None,
                   hbm_bw_util: float | None = None) -> None:
        """Book one dispatch's device-plane sample under ``phase``.
        Engine-thread only (like :meth:`note_step`)."""
        acc = self.phases.get(phase)
        if acc is None:
            acc = self.phases[phase] = _PhaseAcc(self._phase_window)
        acc.update(tokens=tokens, duration_s=duration_s, mfu=mfu,
                   hbm_bw_util=hbm_bw_util)

    def phase_snapshot(self) -> dict[str, dict]:
        """{phase: accounting} for /metrics callbacks and bench
        artifacts (reads cached floats — scrape-thread safe)."""
        return {phase: acc.snapshot()
                for phase, acc in list(self.phases.items())}

    def wrap(self, fn):
        """Wrap a callable so every invocation counts as one dispatch."""
        def counted(*args, **kwargs):
            self.count()
            return fn(*args, **kwargs)
        counted.__wrapped__ = fn
        return counted

    def note_step(self, dispatches: int) -> None:
        self.steps += 1
        self.last_step = int(dispatches)
        # the rolling deque is touched by the engine thread only; the
        # cached float is what /metrics scraper threads read (iterating
        # the deque there could race a concurrent append)
        self._mean = self.per_step.update(dispatches)

    @property
    def mean_per_step(self) -> float:
        return self._mean


class HandoffMeter:
    """Claim-side accounting for disaggregated prefill/decode serving
    (:mod:`~llm_in_practise_tpu_torch.serve.disagg`). The publish side lives on the prefill engine
    (``handoff_published`` / ``handoff_publish_failed``); this meter sits
    in the decode replica's API layer, where handoff ids arrive and
    either resolve to a pinned KV entry or turn out lost. ``/metrics``
    renders these as ``llm_handoff_total{event=...}`` and
    ``llm_handoff_lost_total`` — the llm-d disaggregation dashboards'
    first-order health signal (lost handoffs mean the decode pool is
    paying for prefill again).

    Incremented from concurrent HTTP handler threads (every decode
    replica's ``/v1/chat/completions`` claims here), so the
    read-modify-write increments hold a lock: unlike the engine's
    single-writer counters, two handler threads CAN interleave a
    ``+= 1`` and lose a count. Scrapers read the plain attributes
    lock-free (GIL-atomic reads of monotone ints)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.claimed = 0        # guarded-by: _lock — ids that resolved
        self.lost = 0           # guarded-by: _lock — nothing → re-prefill
        self.repinned = 0       # guarded-by: _lock — re-published sheds
        self.repin_failed = 0   # guarded-by: _lock — re-pins that failed

    def claim_outcome(self, entry_found: bool) -> None:
        with self._lock:
            if entry_found:
                self.claimed += 1
            else:
                self.lost += 1

    def note_repin(self, ok: bool) -> None:
        """Book a shed request's handoff-entry re-pin (api.py's
        queue-full path runs on concurrent handler threads)."""
        with self._lock:
            if ok:
                self.repinned += 1
            else:
                self.repin_failed += 1


class GoodputMeter:
    """SLO goodput: output tokens from requests that met their latency
    SLOs vs tokens from requests that missed them — the number that
    actually prices a serving fleet (raw tok/s counts late tokens
    nobody waited for; DistServe-style goodput does not).

    Thresholds are optional and settable after construction
    (:meth:`configure`) so benches can enable accounting post-warmup.
    A request is **violated** when its measured TTFT or TPOT exceeds
    its SLO; callers that only know total latency (the gateway's
    non-stream path) pass ``total_s`` and the request-level deadline
    ``ttft_slo + (tokens-1)·tpot_slo`` is used instead.

    Per-phase blame: when a violated request carries a trace id and the
    meter has a tracer, the span ring is consulted and the
    longest-duration request-phase span (queue wait / prefill / decode /
    handoff / stream flush / gateway hops) is charged in ``blame`` —
    rendered as ``llm_slo_blame_total{phase=…}``. Cross-process rings
    only see their own spans; missing data degrades to
    ``phase="unknown"``, never to an error.
    """

    # span names eligible for blame, most-specific first (the root
    # api.chat/gateway.route spans cover everything and would always win
    # a max-duration vote, so they are excluded)
    BLAME_SPANS = (
        "engine.queue_wait", "engine.admit", "engine.prefill_chunk",
        "engine.decode", "handoff.publish", "handoff.claim",
        "api.stream_flush", "gateway.prefill_phase", "gateway.cache_lookup",
    )

    def __init__(self, ttft_slo_s: float | None = None,
                 tpot_slo_s: float | None = None, tracer=None):
        self.ttft_slo_s = ttft_slo_s
        self.tpot_slo_s = tpot_slo_s
        self.tracer = tracer
        self._lock = threading.Lock()
        self.tokens_ok = 0           # guarded-by: _lock
        self.tokens_violated = 0     # guarded-by: _lock
        self.requests_ok = 0         # guarded-by: _lock
        self.requests_violated = 0   # guarded-by: _lock
        self.blame: dict[str, int] = {}  # guarded-by: _lock

    def configure(self, ttft_slo_s: float | None = None,
                  tpot_slo_s: float | None = None) -> "GoodputMeter":
        self.ttft_slo_s = ttft_slo_s
        self.tpot_slo_s = tpot_slo_s
        return self

    @property
    def enabled(self) -> bool:
        return self.ttft_slo_s is not None or self.tpot_slo_s is not None

    def observe(self, *, tokens: int, ttft_s: float | None = None,
                tpot_s: float | None = None, total_s: float | None = None,
                trace_id: str | None = None) -> bool:
        """Book one finished request; returns True when it violated."""
        if not self.enabled:
            return False
        violated = False
        if (self.ttft_slo_s is not None and ttft_s is not None
                and ttft_s > self.ttft_slo_s):
            violated = True
        if (self.tpot_slo_s is not None and tpot_s is not None
                and tpot_s > self.tpot_slo_s):
            violated = True
        if (not violated and ttft_s is None and tpot_s is None
                and total_s is not None):
            # request-level deadline when only end-to-end latency is
            # known: the time a client meeting both SLOs would tolerate
            deadline = ((self.ttft_slo_s or 0.0)
                        + max(int(tokens) - 1, 0) * (self.tpot_slo_s or 0.0))
            violated = deadline > 0 and total_s > deadline
        with self._lock:
            if violated:
                self.requests_violated += 1
                self.tokens_violated += int(tokens)
            else:
                self.requests_ok += 1
                self.tokens_ok += int(tokens)
        if violated:
            self._record_blame(trace_id)
        return violated

    def _record_blame(self, trace_id: str | None) -> None:
        phase = "unknown"
        try:
            if trace_id and self.tracer is not None:
                spans = [s for s in self.tracer.trace(trace_id)
                         if s["name"] in self.BLAME_SPANS
                         and s.get("duration_s")]
                if spans:
                    phase = max(spans, key=lambda s: s["duration_s"])["name"]
        except Exception:  # noqa: BLE001 — blame is best-effort; a ring
            # hiccup must not fail the request accounting
            phase = "unknown"
        with self._lock:
            self.blame[phase] = self.blame.get(phase, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ttft_slo_s": self.ttft_slo_s,
                "tpot_slo_s": self.tpot_slo_s,
                "tokens_ok": self.tokens_ok,
                "tokens_violated": self.tokens_violated,
                "requests_ok": self.requests_ok,
                "requests_violated": self.requests_violated,
                "blame": dict(self.blame),
            }


def register_goodput(registry, meter: GoodputMeter, *,
                     subject: str = "output tokens") -> None:
    """Register the goodput family triplet over ``meter`` — the ONE
    definition both the gateway and the model server expose
    (``llm_goodput_tokens_total`` / ``llm_slo_requests_total`` /
    ``llm_slo_blame_total``; docs/observability.md "Device plane").
    ``registry`` is any object with ``counter_func`` (obs.registry).
    All-zero until the meter's thresholds are configured.

    Every family reads through :meth:`GoodputMeter.snapshot` (one lock
    acquisition per collect): the ok/violated pair of a family comes
    from ONE consistent view, so a scrape can never render an ok count
    from before an observe and a violated count from after it (the
    scrape-callback-vs-writer torn read the lock-discipline pass
    flags)."""
    registry.counter_func(
        "llm_goodput_tokens_total",
        lambda: [
            ({"slo": "ok"}, (s := meter.snapshot())["tokens_ok"]),
            ({"slo": "violated"}, s["tokens_violated"])],
        f"{subject} by SLO outcome of their request")
    registry.counter_func(
        "llm_slo_requests_total",
        lambda: [
            ({"slo": "ok"}, (s := meter.snapshot())["requests_ok"]),
            ({"slo": "violated"}, s["requests_violated"])],
        "finished requests by SLO outcome")
    registry.counter_func(
        "llm_slo_blame_total",
        lambda: [({"phase": phase}, count)
                 for phase, count in sorted(meter.snapshot()
                                            ["blame"].items())],
        "SLO-violating requests by their longest span-ring phase")


# One trace at a time, process-wide: the CUDA profiler (CUPTI) takes one
# session per process, and a nested profile would stop the outer one on
# its way out. ProfilerCapture (POST /debug/profile) checks it too.
_profile_lock = threading.Lock()


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``with profile_trace("/tmp/trace"):`` — a ``torch.profiler`` trace
    (CPU and, with a card, CUDA activities) around the block, written on
    exit as ``<log_dir>/<pid>.trace.json.gz`` (a gzipped Chrome trace that
    Perfetto opens); None disables it (zero overhead). Yields the
    profiler, or None when disabled.

    Reentrancy-safe: while a trace is active (this thread or another;
    ``POST /debug/profile`` races are real), a nested or concurrent entry
    degrades to a no-op (yields None) instead of stopping the outer
    capture. The profiler is stopped on every exit, and a failed export
    never masks the block's own exception."""
    if not log_dir:
        yield None
        return
    if not _profile_lock.acquire(blocking=False):
        yield None
        return
    try:
        from torch.profiler import profile

        prof = profile(activities=_activities())
        prof.start()
        try:
            yield prof
        finally:
            try:
                prof.stop()
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(log_dir, f"{os.getpid()}.trace.json.gz"))
            except Exception:  # noqa: BLE001 — never mask the block's
                # exception with a profiler teardown fault
                pass
    finally:
        _profile_lock.release()


@contextlib.contextmanager
def exclusive_profile(**kwargs):
    """A caller's own ``torch.profiler.profile(**kwargs)``, entered under
    the lock :func:`profile_trace` and ``POST /debug/profile`` take: it
    waits for a capture in progress, and a capture asked for meanwhile
    answers busy."""
    from torch.profiler import profile

    with _profile_lock, profile(**kwargs) as prof:
        yield prof


class EpochTimer:
    def __init__(self):
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.start
