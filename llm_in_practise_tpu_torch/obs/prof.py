"""On-demand profiler capture and compile telemetry (port of
``llm_in_practise_tpu/obs/prof.py``).

- :class:`ProfilerCapture`: the machinery behind ``POST /debug/profile``
  (served by every HTTP server through ``serve/http_util.py``): a
  bounded-duration ``torch.profiler`` trace (CPU and CUDA activities)
  into a fresh directory, ONE capture at a time process-wide (a second
  request, or one while :func:`~.meter.profile_trace` or
  :func:`~.meter.exclusive_profile` holds the lock, gets
  :class:`ProfilerBusyError`: HTTP 409). The profiler records every
  thread of the process, so a capture taken on an HTTP thread holds the
  kernels the engine thread launches meanwhile. The response names the
  gzipped Chrome trace it wrote (Perfetto opens it).
- :class:`CompileMeter`: the serving thread's one-time stalls. The JAX
  package counts jit executable-cache misses; the port's counterparts
  are the engine's CUDA-graph captures (``serve/graphs.py`` reports each
  capture's seconds) and the kernel builds of ``ops/_build.py`` that run
  inside a server's life (:func:`note_build`).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
import weakref


class ProfilerBusyError(RuntimeError):
    """A capture is already in progress (one at a time, process-wide)."""


class ProfilerCapture:
    """Bounded on-demand ``torch.profiler`` capture.

    ``base_dir`` defaults to ``$LLM_TPU_PROFILE_DIR`` or a per-process
    directory under the system temp dir; each capture gets a fresh
    timestamped subdirectory (captures never clobber each other)."""

    MAX_DURATION_S = 60.0
    MIN_DURATION_S = 0.05

    def __init__(self, base_dir: str | None = None):
        self.base_dir = (base_dir
                         or os.environ.get("LLM_TPU_PROFILE_DIR")
                         or os.path.join(tempfile.gettempdir(),
                                         f"llm_tpu_profile_{os.getpid()}"))
        self._lock = threading.Lock()
        # counter lock, NOT the capture lock: busy rejections happen
        # exactly when _lock could not be acquired, and concurrent 409s
        # racing a bare `+= 1` would lose counts
        self._stats_lock = threading.Lock()
        self.captures = 0           # guarded-by: _stats_lock
        self.busy_rejections = 0    # guarded-by: _stats_lock

    def _busy(self, message: str) -> ProfilerBusyError:
        with self._stats_lock:
            self.busy_rejections += 1
        return ProfilerBusyError(message)

    def capture(self, duration_s: float = 2.0, quiesce=None) -> dict:
        """Record ``duration_s`` (clamped to [MIN, MAX]) of activity;
        returns ``{"trace_dir", "duration_s", "files", "perfetto"}``.
        ``quiesce``: as :func:`~.meter.profile_trace` takes it.
        Raises :class:`ProfilerBusyError` when a capture or another
        profiler session of this process is running."""
        duration = min(max(float(duration_s), self.MIN_DURATION_S),
                       self.MAX_DURATION_S)
        if not self._lock.acquire(blocking=False):
            raise self._busy(
                "a profiler capture is already in progress — retry when "
                "it finishes (captures are bounded at "
                f"{self.MAX_DURATION_S:.0f}s)")
        try:
            from llm_in_practise_tpu_torch.obs import meter

            # a session someone ELSE holds makes profile_trace degrade to
            # a no-op: that must be a 409, never a 200 with no trace
            if meter._profile_lock.locked():
                raise self._busy(
                    "a torch.profiler session is already active in this "
                    "process — retry when it finishes")
            with self._stats_lock:
                n_prior = self.captures
            out_dir = os.path.join(
                self.base_dir,
                time.strftime("capture-%Y%m%d-%H%M%S") + f"-{n_prior}")
            os.makedirs(out_dir, exist_ok=True)
            with meter.profile_trace(out_dir, quiesce) as prof:
                if prof is None:
                    # the locked() check above raced another session
                    raise self._busy(
                        "a concurrent torch.profiler session took the "
                        "profiler first; retry")
                time.sleep(duration)
            files = sorted(
                os.path.join(root, name)
                for root, _, names in os.walk(out_dir)
                for name in names)
            if not files:
                raise RuntimeError(
                    f"the profiler wrote no trace under {out_dir}")
            with self._stats_lock:
                self.captures += 1
            return {
                "trace_dir": out_dir,
                "duration_s": duration,
                "files": files,
                # the gzipped Chrome trace: https://ui.perfetto.dev opens it
                "perfetto": [f for f in files
                             if f.endswith(".trace.json.gz")],
            }
        finally:
            self._lock.release()


_default_profiler: ProfilerCapture | None = None
_default_lock = threading.Lock()


def get_profiler() -> ProfilerCapture:
    """Process-wide capture singleton: every server's ``POST
    /debug/profile`` shares the one-at-a-time lock."""
    global _default_profiler
    with _default_lock:
        if _default_profiler is None:
            _default_profiler = ProfilerCapture()
        return _default_profiler


class CompileMeter:
    """One-time stalls the serving thread paid: each CUDA-graph capture of
    the engine's step paths (with its seconds, the capture's own eager
    warm-up run excluded, as ``StepGraphs.capture_s`` times it) and each
    kernel build that ran inside the server's life. Thread-safe
    counters; scrapers read plain attributes."""

    def __init__(self):
        self._lock = threading.Lock()
        self.compile_events = 0      # guarded-by: _lock
        self.compile_seconds = 0.0   # guarded-by: _lock

    def note(self, seconds: float) -> None:
        with self._lock:
            self.compile_events += 1
            self.compile_seconds += float(seconds)


# every live CompileMeter hears of a kernel build (ops/_build.py builds
# once per process, at the first call of a kernel, whichever engine made
# it)
_build_meters: "weakref.WeakSet[CompileMeter]" = weakref.WeakSet()
_build_meters_lock = threading.Lock()


def watch_builds(meter: CompileMeter) -> None:
    """Book every later kernel build of this process into ``meter``."""
    with _build_meters_lock:
        _build_meters.add(meter)


def unwatch_builds(meter: CompileMeter) -> None:
    with _build_meters_lock:
        _build_meters.discard(meter)


def note_build(seconds: float) -> None:
    """One kernel build of ``seconds`` (nvcc and load), booked into every
    watching meter (``ops/_build.py`` calls it)."""
    with _build_meters_lock:
        meters = list(_build_meters)
    for m in meters:
        m.note(seconds)
