"""Host-gap flight recorder — the per-step engine-loop timeline (a copy of
``llm_in_practise_tpu/obs/steptrace.py``, which imports no JAX).

In the port the engine books as device time what the card did: a pair of
CUDA events around each dispatch on the engine's stream, read after the
fetch the engine already makes and clamped to the dispatch window's wall
time (on the CPU, the window's wall time). An eager prefill is
launch-bound, so its event span also holds the gaps between its
launches: the busy fraction is an upper bound there.

The device plane (obs/cost.py) books what happens *inside* a
dispatch; this module books the time *between* dispatches — the host
work (queue scans, admission, index building, drafting, sampling
commits) that arxiv 2311.03687's runtime dissection shows dominating
bandwidth-bound decode, and that an async-overlap refactor must
drive to zero. The recorder turns "the chip never waits
on Python" from a hope into a gated, regression-tested quantity:

- :class:`StepTrace` — a bounded ring of per-step records. The engine
  brackets each ``step()`` with :meth:`step_begin`/:meth:`step_end` and
  marks named host activities with :meth:`scope`; every device dispatch
  reports its device time through the engine's
  ``_note_device_phase``, which feeds :meth:`note_device`. At step end
  the record partitions the step's wall clock into
  ``{activity: seconds}`` + device-busy seconds + an ``other``
  remainder, so coverage (1 − other/wall) is a first-class number the
  serve benches gate on (≥ 95 %).
- **Scopes nest**: entering an inner scope pauses the enclosing one, so
  ``index_build`` inside ``admit`` is attributed once, not twice.
  Device time reported mid-scope is deducted from the surrounding host
  activity (the ``dispatch_wait`` leftover is then the *host-side*
  overhead of the dispatch window: argument conversion, fetch slack).
- **Single-writer**: every mutation happens on the engine thread.
  Scrape threads read :meth:`snapshot` — an atomically swapped dict
  rebuilt once per step — so ``/metrics`` callbacks can never see a
  half-updated step (the torn-read class graftlint's lock pass flags).
- **Dual-lane Perfetto export**: with a Chrome-JSONL sink attached to
  the tracer (``--trace-file`` / ``LLM_TPU_TRACE_FILE``), each step's
  host segments and device dispatch windows are written as trace
  events on two synthetic threads ("engine host lane" / "device lane"),
  so the gaps between device slices are *visible* in Perfetto instead
  of inferred from counters.

``LLM_TPU_STEPTRACE=off`` disables recording entirely (every hook
degrades to an attribute check; golden tokens are identical either way
— pinned by ``tests/test_steptrace.py``).

Activity glossary (docs/observability.md "Host timeline"):

=================  ==========================================================
``queue_drain``    pending-queue scans: timeout sheds + dequeues
``admit``          admission bookkeeping — prefix lookup, page reservation,
                   slot setup (inner segments excluded)
``plan``           decode-block/spec-extension planning + fusibility checks
``index_build``    host assembly of dispatch inputs (token, index,
                   gather/scatter arrays)
``draft_propose``  speculative drafting on the host (ngram scan or
                   draft-model sync + roll)
``grammar_compile`` lazy per-state grammar compilation — vocab-wide token
                   classification on first visit of an automaton state
                   (serve/constrain.py)
``grammar_mask``   per-step staging of the grammar logit masks for
                   constrained slots (compiled-state lookups + array fill)
``adapter_gather`` per-dispatch assembly of the multi-LoRA bank args —
                   slot→row index build + bank snapshot handoff
                   (serve/multi_lora.py)
``dispatch_wait``  jitted-dispatch windows net of the device-booked time
``sample_commit``  per-token commit/emit loops + prefill finalization
``publish``        handoff entry gather/queue on the engine thread
``other``          unattributed remainder (the coverage gate bounds it)
=================  ==========================================================
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

ACTIVITIES = ("queue_drain", "admit", "plan", "index_build",
              "draft_propose", "grammar_compile", "grammar_mask",
              "adapter_gather", "dispatch_wait", "sample_commit",
              "publish", "other")

# synthetic Chrome-trace thread ids for the dual-lane view; request
# spans use real thread idents (< 2^31), so these can't collide
HOST_LANE_TID = (1 << 31) + 1
DEVICE_LANE_TID = (1 << 31) + 2

_MAX_SEGMENTS_PER_STEP = 256    # timeline-capture bound per step


def _enabled_from_env() -> bool:
    return os.environ.get("LLM_TPU_STEPTRACE", "").lower() not in (
        "off", "0", "false")


class _Scope:
    """Reusable context manager for one named activity — allocated once
    per (recorder, name) so the hot loop pays attribute access, not
    object churn. Engine-thread only, non-reentrant per name (the
    engine never nests a scope inside itself)."""

    __slots__ = ("_st", "name")

    def __init__(self, st: "StepTrace", name: str):
        self._st = st
        self.name = name

    def __enter__(self):
        self._st._enter(self.name)
        return self

    def __exit__(self, *exc):
        self._st._exit()
        return False


class _NoopScope:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SCOPE = _NoopScope()


class StepTrace:
    """Bounded per-step flight recorder for the engine loop.

    Thread model: ``step_begin``/``step_end``/``scope``/``note_device``
    run on the engine thread only (single writer). The ring is guarded
    for the ``/debug``-style readers; cumulative totals and fractions
    are published through an atomically swapped snapshot dict that
    scrape threads read without locks.
    """

    def __init__(self, capacity: int = 2048, *, enabled: bool | None = None,
                 window: int = 50):
        self.enabled = _enabled_from_env() if enabled is None else enabled
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)  # guarded-by: _lock
        self._lock = threading.Lock()
        # --- engine-thread state (single writer, no lock) ---
        self._scopes = {name: _Scope(self, name) for name in ACTIVITIES}
        self._stack: list[list] = []      # [name, last_perf, acc, deduct]
        self._step_t0: float | None = None
        self._step_wall0 = 0.0
        self._acts: dict[str, float] = {}
        self._device_s = 0.0
        self._dispatches = 0
        self._segments: list[tuple] | None = None  # timeline capture
        self._seq = 0
        # --- cumulative totals (engine-thread writes; scrapes read the
        # swapped snapshot, never these) ---
        self._host_seconds = {a: 0.0 for a in ACTIVITIES}
        self._steps_total = 0
        self._step_wall_total = 0.0
        self._device_seconds_total = 0.0
        # rolling fractions over the last `window` steps (cached floats,
        # same convention as DispatchMeter.per_step)
        self._window = window
        self._busy_roll: deque = deque(maxlen=window)  # (wall, device)
        self._snap = self._build_snapshot()

    # -- engine-thread hooks --------------------------------------------------

    def scope(self, name: str):
        """``with st.scope("admit"):`` — attribute the enclosed wall
        time (minus inner scopes and device time) to ``name``."""
        if not self.enabled or self._step_t0 is None:
            return _NOOP_SCOPE
        return self._scopes[name]

    def _enter(self, name: str) -> None:
        now = time.perf_counter()
        if self._stack:
            top = self._stack[-1]
            top[2] += now - top[1]
        self._stack.append([name, now, 0.0, 0.0])
        if self._segments is not None:
            # timeline capture: remember the wall start; duration fills
            # in at exit (host lane shows gross spans — nesting is
            # visible as containment, like any flame chart)
            self._stack[-1].append(time.time())

    def _exit(self) -> None:
        now = time.perf_counter()
        frame = self._stack.pop()
        name, last, acc, deduct = frame[0], frame[1], frame[2], frame[3]
        host = max(0.0, acc + (now - last) - deduct)
        self._acts[name] = self._acts.get(name, 0.0) + host
        if self._stack:
            self._stack[-1][1] = now
        if (self._segments is not None and len(frame) > 4
                and len(self._segments) < _MAX_SEGMENTS_PER_STEP):
            # GROSS span (enter → exit wall clock): Perfetto nests
            # overlapping same-tid slices, so inner scopes render as
            # children; device windows overlap from the device lane
            self._segments.append(
                ("host", name, frame[4], time.time() - frame[4]))

    def note_device(self, duration_s: float, phase: str = "dispatch") -> None:
        """Book one dispatch's forced wall time to the device lane and
        deduct it from the current host activity (the engine measures
        ``duration_s`` inside a host scope, so without the deduction the
        same wall clock would count twice)."""
        if not self.enabled or self._step_t0 is None:
            return
        self._device_s += float(duration_s)
        self._dispatches += 1
        if self._stack:
            self._stack[-1][3] += float(duration_s)
        if (self._segments is not None
                and len(self._segments) < _MAX_SEGMENTS_PER_STEP):
            self._segments.append(
                ("device", f"device.{phase}",
                 time.time() - duration_s, duration_s))

    def step_begin(self, *, timeline: bool = False) -> None:
        """Open a step record. ``timeline=True`` additionally captures
        per-segment (start, duration) intervals for the Perfetto
        dual-lane export (only worth paying when a JSONL sink exists)."""
        if not self.enabled:
            return
        self._step_t0 = time.perf_counter()
        self._step_wall0 = time.time()
        self._acts = {}
        self._device_s = 0.0
        self._dispatches = 0
        self._stack = []
        self._segments = [] if timeline else None

    def step_abort(self) -> None:
        """Discard the open record (idle background-loop polls must not
        decay the fractions to meaninglessness — same rule as
        ``DispatchMeter.note_step``)."""
        self._step_t0 = None
        self._segments = None

    def step_end(self, tracer=None) -> dict | None:
        """Close the record: derive ``other``, append to the ring,
        refresh the cumulative totals + the scrape snapshot, and (with a
        sink-carrying ``tracer``) emit the dual-lane Chrome events.
        Returns the record dict (bench/test introspection)."""
        if not self.enabled or self._step_t0 is None:
            return None
        wall = time.perf_counter() - self._step_t0
        # a scope left open by an exception would leak its time into
        # `other`; close anything still on the stack so the record
        # stays a partition
        while self._stack:
            self._exit()
        attributed = sum(self._acts.values()) + self._device_s
        other = max(0.0, wall - attributed)
        self._acts["other"] = self._acts.get("other", 0.0) + other
        self._seq += 1
        rec = {
            "seq": self._seq,
            "start_s": self._step_wall0,
            "wall_s": wall,
            "device_s": self._device_s,
            "dispatches": self._dispatches,
            "activities": dict(self._acts),
        }
        with self._lock:
            self._ring.append(rec)
        for name, dt in self._acts.items():
            self._host_seconds[name] = self._host_seconds.get(name, 0.0) + dt
        self._steps_total += 1
        self._step_wall_total += wall
        self._device_seconds_total += self._device_s
        self._busy_roll.append((wall, self._device_s))
        segments = self._segments
        self._step_t0 = None
        self._segments = None
        self._snap = self._build_snapshot()
        if tracer is not None and segments:
            self._emit_timeline(tracer, segments)
        return rec

    # -- scrape-side reads ----------------------------------------------------

    def _build_snapshot(self) -> dict:
        roll_wall = sum(w for w, _ in self._busy_roll)
        roll_dev = sum(d for _, d in self._busy_roll)
        busy = (roll_dev / roll_wall) if roll_wall > 0 else 0.0
        wall = self._step_wall_total
        dev = self._device_seconds_total
        other = self._host_seconds.get("other", 0.0)
        return {
            "enabled": self.enabled,
            "steps": self._steps_total,
            "step_wall_seconds_total": wall,
            "device_seconds_total": dev,
            "host_seconds": dict(self._host_seconds),
            # rolling over the last `window` steps — the live dial. A
            # recorder that measured nothing (fresh, idle, or disabled)
            # reports 0 host gap, NOT 1 − busy = 1.0: "the chip waits
            # on Python 100%" must never be the default reading
            "device_busy_fraction": busy,
            "host_gap_fraction": (max(0.0, 1.0 - busy)
                                  if roll_wall > 0 else 0.0),
            # lifetime coverage: attributed activities + device over
            # wall (the ≥ 0.95 gate the serve benches assert); 0.0 with
            # no recorded steps so the gate can never pass vacuously
            "coverage": ((wall - other) / wall) if wall > 0 else 0.0,
        }

    def snapshot(self) -> dict:
        """One consistent view for ``/metrics`` callbacks and bench
        artifacts — the dict reference is swapped atomically at step
        end, so a scrape never mixes two steps' totals."""
        return self._snap

    def records(self, limit: int = 256) -> list[dict]:
        """Most recent step records, oldest first (``/debug`` reads)."""
        with self._lock:
            out = list(self._ring)
        return out[-limit:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- Perfetto dual-lane export --------------------------------------------

    _meta_sink: str | None = None
    # JSON-quoted activity names of the timeline's events, made once
    _quoted: dict = {}

    def _emit_timeline(self, tracer, segments) -> None:
        if not getattr(tracer, "has_file_sink", False):
            return
        pid = os.getpid()
        lines = []
        # lane metadata once PER SINK, not per recorder: a rotated
        # trace file must carry its own thread_name events or the
        # dual-lane view renders as raw synthetic tids
        sink = getattr(tracer, "file_sink_path", None) or "<sink>"
        if sink != self._meta_sink:
            self._meta_sink = sink
            for tid, label in ((HOST_LANE_TID, "engine host lane"),
                               (DEVICE_LANE_TID, "device lane")):
                lines.append(json.dumps(
                    {"ph": "M", "pid": pid, "tid": tid,
                     "name": "thread_name", "args": {"name": label}}) + "\n")
        # the step's events go to the sink as one pre-formatted chunk
        # (the JSON objects of JAX's export, keys in the same order): one
        # lock and one write, not a json.dumps and a lock per event, on
        # the engine thread between two steps
        quoted = self._quoted
        for lane, name, start_wall, dur in segments:
            q = quoted.get(name)
            if q is None:
                q = quoted[name] = json.dumps(name)
            tid = HOST_LANE_TID if lane == "host" else DEVICE_LANE_TID
            lines.append(
                f'{{"ph": "X", "cat": "steptrace", "name": {q}, '
                f'"ts": {start_wall * 1e6!r}, "dur": {dur * 1e6!r}, '
                f'"pid": {pid}, "tid": {tid}}}\n')
        tracer.write_raw("".join(lines))
