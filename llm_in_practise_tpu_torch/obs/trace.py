"""End-to-end request tracing for the disaggregated serving path (a copy
of ``llm_in_practise_tpu/obs/trace.py``, which imports no JAX: the port
keeps its own).

A request that crosses gateway → prefill replica → kv-pool handoff →
decode replica previously left no correlated record: "where did this
request's 900 ms go" was unanswerable. This module is the trace plane:

- :class:`TraceContext` — (trace_id, span_id) pair. Propagated over the
  gateway→replica and prefill→decode HTTP hops via a
  ``traceparent``-style header (W3C format, ``00-<32 hex>-<16 hex>-01``)
  and through ``kv_transfer_params`` (the handoff body carries the
  trace id so the decode replica's claim span joins the same trace even
  when an intermediary strips headers).
- :class:`Span` — one timed operation (gateway routing, cache lookup,
  queue wait, admission, a prefill chunk, handoff publish/claim, the
  decode phase, stream flush) with attributes.
- :class:`Tracer` — bounded in-memory ring buffer of finished spans
  (a long-running server's trace plane must be O(capacity), never
  O(requests)), served as JSON at ``GET /debug/traces`` by every HTTP
  server in the stack, plus an optional Chrome trace-event JSONL file
  (one event per line) that Perfetto / ``chrome://tracing`` open
  directly.

Span creation is a couple of dict ops and a monotonic read — cheap
enough to stay on by default. ``LLM_TPU_TRACE=off`` disables recording
entirely (spans become no-ops and headers are not minted).

Thread model: spans are recorded from HTTP handler threads, the engine
loop, and the handoff publisher pool concurrently; the ring and the
JSONL file are guarded by separate locks (file I/O never blocks ring
appends or scrape reads). A span is immutable once ``end()`` runs;
consumers only ever see finished spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import secrets
import threading
import time
from collections import deque

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")

TRACEPARENT_HEADER = "traceparent"


def _log():
    from llm_in_practise_tpu_torch.obs.logging import get_logger

    return get_logger("obs.trace")


def new_trace_id() -> str:
    return secrets.token_hex(16)


def new_span_id() -> str:
    return secrets.token_hex(8)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The propagatable identity of a point in a trace: children parent
    to ``span_id``, everything shares ``trace_id``."""

    trace_id: str
    span_id: str


def new_context() -> TraceContext:
    return TraceContext(new_trace_id(), new_span_id())


def parse_traceparent(header: str | None) -> TraceContext | None:
    """Strict parse of a ``traceparent`` header; ``None`` on absence or
    malformation (a bad header starts a fresh trace, never an error —
    tracing must not be able to fail a request)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id)


def format_traceparent(ctx: TraceContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


class Span:
    """One timed operation. Created via :meth:`Tracer.start_span` /
    :meth:`Tracer.span`; finished exactly once by :meth:`end`."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_wall",
                 "_start_perf", "duration_s", "attrs", "_tracer")

    def __init__(self, tracer, name: str, trace_id: str, span_id: str,
                 parent_id: str | None, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_wall = time.time()
        self._start_perf = time.perf_counter()
        self.duration_s: float | None = None
        self.attrs = attrs

    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, **attrs) -> None:
        if self.duration_s is not None:  # end-once: late ends are no-ops
            return
        self.attrs.update(attrs)
        self.duration_s = time.perf_counter() - self._start_perf
        tracer, self._tracer = self._tracer, None
        if tracer is not None:
            tracer._finish(self)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_s": self.start_wall,
            "duration_s": self.duration_s,
            "attrs": dict(self.attrs),
        }


class _NoopSpan:
    """Stands in when tracing is disabled; context() returns the parent
    untouched so propagation degrades to pass-through."""

    __slots__ = ("_ctx",)

    def __init__(self, ctx: TraceContext | None):
        self._ctx = ctx

    def context(self) -> TraceContext | None:
        return self._ctx

    def set(self, **attrs):
        return self

    def end(self, **attrs) -> None:
        pass


def _to_context(parent) -> TraceContext | None:
    """Normalize a parent (Span, _NoopSpan, TraceContext, or None) to a
    TraceContext-or-None. _NoopSpans appear as parents whenever tracing
    is disabled — they must unwrap to the context they carry, never leak
    as-is (a _NoopSpan has no trace_id and would crash
    format_traceparent at the gateway's handoff hop)."""
    if isinstance(parent, (Span, _NoopSpan)):
        return parent.context()
    return parent


def _parent_of(parent) -> tuple[str, str | None]:
    """(trace_id, parent_span_id) for a parent that is a TraceContext,
    a Span, a _NoopSpan (unwrapped), or None (fresh root)."""
    if isinstance(parent, _NoopSpan):
        parent = parent.context()
    if parent is None:
        return new_trace_id(), None
    return parent.trace_id, parent.span_id


class Tracer:
    """Bounded ring of finished spans + optional Chrome-JSONL sink."""

    def __init__(self, capacity: int = 4096, *, enabled: bool | None = None,
                 trace_file: str | None = None):
        if enabled is None:
            enabled = os.environ.get("LLM_TPU_TRACE", "").lower() not in (
                "off", "0", "false")
        self.enabled = enabled
        self._ring: deque[Span] = deque(maxlen=capacity)  # guarded-by: _lock
        self._lock = threading.Lock()
        self.spans_recorded = 0  # guarded-by: _lock
        # the JSONL sink has its own lock: a slow disk must serialize
        # only the writers, never the ring appends (engine loop) or the
        # ring reads (/debug/traces scrapes) behind file I/O
        self._file_lock = threading.Lock()
        self._file = None        # guarded-by: _file_lock
        self._file_path = None   # guarded-by: _file_lock
        if trace_file:
            self.set_trace_file(trace_file)

    # -- span lifecycle -------------------------------------------------------

    def start_span(self, name: str, parent=None, **attrs):
        """``parent``: a :class:`TraceContext` (e.g. from an incoming
        ``traceparent`` header), a live :class:`Span`, or ``None`` for a
        new root. Returns the span; call ``.end()`` when done."""
        if not self.enabled:
            return _NoopSpan(_to_context(parent))
        trace_id, parent_id = _parent_of(parent)
        return Span(self, name, trace_id, new_span_id(), parent_id, attrs)

    @contextlib.contextmanager
    def span(self, name: str, parent=None, **attrs):
        sp = self.start_span(name, parent, **attrs)
        try:
            yield sp
        finally:
            sp.end()

    def record(self, name: str, parent=None, *, duration_s: float,
               end_wall: float | None = None, **attrs):
        """Record an already-timed operation (the engine stamps request
        phases with monotonic times and reports them at completion).
        ``end_wall`` defaults to now; the span's start is derived."""
        if not self.enabled:
            return _NoopSpan(_to_context(parent))
        trace_id, parent_id = _parent_of(parent)
        sp = Span(self, name, trace_id, new_span_id(), parent_id, attrs)
        end = end_wall if end_wall is not None else time.time()
        sp.start_wall = end - duration_s
        sp.duration_s = float(duration_s)
        tracer, sp._tracer = sp._tracer, None
        tracer._finish(sp)
        return sp

    def _finish(self, span: Span) -> None:
        with self._lock:
            self.spans_recorded += 1
            self._ring.append(span)
        # racy-but-rechecked fast path: most deployments have no sink,
        # and a stale read here only costs one serialize-or-skip — the
        # authoritative check runs under the lock below
        if self._file is None:  # racy read (see has_file_sink)
            return
        self._write_line(json.dumps(_chrome_event(span)) + "\n")

    def _write_line(self, line: str) -> None:
        with self._file_lock:
            if self._file is None:
                return
            try:
                # buffered write, no per-line flush: the recording
                # thread (engine loop included) pays a memcpy, not disk
                # latency; set_trace_file(None) flushes on close and a
                # crash loses at most the buffer tail of a debug sink
                self._file.write(line)
            except OSError as e:
                # sink died (ENOSPC, revoked mount, …): log ONCE, close
                # the handle (don't leak a buffered writer to GC), and
                # keep serving — tracing must not be able to fail a
                # request
                _log().warning(
                    "trace sink %s died (%s: %s) — Chrome JSONL "
                    "truncates here, ring + /debug/traces unaffected",
                    self._file_path, type(e).__name__, e)
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
                self._file_path = None

    @property
    def has_file_sink(self) -> bool:
        """True while a Chrome-JSONL sink is open (racy read — callers
        use it to skip work, the write path rechecks under the lock)."""
        return self._file is not None  # racy read: the write path rechecks

    @property
    def file_sink_path(self) -> str | None:
        """Current sink path, None when closed (racy read, same
        contract as ``has_file_sink``) — lets the steptrace dual-lane
        export re-emit its lane metadata after a sink rotation."""
        return self._file_path  # racy read (see has_file_sink)

    def write_event(self, event: dict) -> None:
        """Write one raw Chrome trace event to the JSONL sink only — no
        ring entry. The steptrace dual-lane timeline
        (:mod:`llm_in_practise_tpu_torch.obs.steptrace`) rides here: per-step
        host/device lane slices would evict real request spans if they
        went through the bounded ring."""
        if self._file is None:  # racy read (see has_file_sink)
            return
        self._write_line(json.dumps(event) + "\n")

    def write_raw(self, text: str) -> None:
        """Write already-serialized JSONL (whole lines) to the sink only,
        under one lock: the step recorder's per-step lane events."""
        if self._file is None:  # racy read (see has_file_sink)
            return
        self._write_line(text)

    # -- consumption ----------------------------------------------------------

    def spans(self) -> list[dict]:
        with self._lock:
            snapshot = list(self._ring)
        # serialize OUTSIDE the lock: a full-ring /debug/traces scrape
        # must never stall concurrent span finishes (finished spans are
        # immutable, so the copies are race-free)
        return [s.to_dict() for s in snapshot]

    def traces(self, limit: int = 64) -> list[dict]:
        """Most-recent traces (grouped spans), newest last."""
        return self._traces_of(self.spans(), limit)

    @staticmethod
    def _traces_of(spans: list[dict], limit: int) -> list[dict]:
        by_id: dict[str, list[dict]] = {}
        order: list[str] = []
        for s in spans:
            if s["trace_id"] not in by_id:
                by_id[s["trace_id"]] = []
                order.append(s["trace_id"])
            by_id[s["trace_id"]].append(s)
        out = []
        for tid in order[-limit:]:
            grouped = sorted(by_id[tid], key=lambda s: s["start_s"])
            out.append({"trace_id": tid, "spans": grouped})
        return out

    def trace(self, trace_id: str) -> list[dict]:
        return sorted((s for s in self.spans()
                       if s["trace_id"] == trace_id),
                      key=lambda s: s["start_s"])

    def summary(self) -> dict:
        return self._summary_of(self.spans())

    def _summary_of(self, spans: list[dict]) -> dict:
        with self._lock:
            recorded = self.spans_recorded
        names: dict[str, int] = {}
        durs: dict[str, float] = {}
        for s in spans:
            names[s["name"]] = names.get(s["name"], 0) + 1
            durs[s["name"]] = durs.get(s["name"], 0.0) + (
                s["duration_s"] or 0.0)
        return {
            "spans_recorded": recorded,
            "spans_buffered": len(spans),
            "traces_buffered": len({s["trace_id"] for s in spans}),
            "span_counts": names,
            "span_seconds_total": {k: round(v, 6) for k, v in durs.items()},
        }

    def debug_payload(self, limit: int = 64) -> dict:
        """The ``GET /debug/traces`` body every server serves. One ring
        snapshot feeds both halves (the ring lock is contended with
        every span finish — take it once, not three times)."""
        spans = self.spans()
        return {"summary": self._summary_of(spans),
                "traces": self._traces_of(spans, limit)}

    # -- Chrome trace-event sink ----------------------------------------------

    def set_trace_file(self, path: str | None) -> None:
        """Append Chrome trace events (one JSON object per line) to
        ``path``. Perfetto and ``chrome://tracing`` open the file
        directly (the JSON trace loader accepts newline-delimited
        events). ``None`` closes the sink."""
        with self._file_lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
            self._file_path = path
            if path:
                try:
                    self._file = open(path, "a", encoding="utf-8")
                except OSError as e:
                    # fail OPEN: a bad LLM_TPU_TRACE_FILE must not take
                    # down engine/server construction (the first
                    # get_tracer() happens there) — ring + /debug/traces
                    # keep working without the file sink
                    _log().warning(
                        "cannot open trace file %s (%s: %s) — Chrome "
                        "JSONL sink disabled, ring tracing unaffected",
                        path, type(e).__name__, e)
                    self._file = None
                    self._file_path = None


def _chrome_event(span: Span) -> dict:
    return {
        "ph": "X",
        "cat": "serve",
        "name": span.name,
        "ts": span.start_wall * 1e6,
        "dur": (span.duration_s or 0.0) * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident() % (1 << 31),
        "args": {"trace_id": span.trace_id, "span_id": span.span_id,
                 "parent_id": span.parent_id, **span.attrs},
    }


_default_tracer: Tracer | None = None
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    """Process-wide default tracer — the engine, API server, and gateway
    all record here unless constructed with an explicit tracer, so a
    single-process stack (tests, chip-sharing colocations) yields one
    correlated trace plane."""
    global _default_tracer
    with _default_lock:
        if _default_tracer is None:
            _default_tracer = Tracer(
                trace_file=os.environ.get("LLM_TPU_TRACE_FILE") or None)
        return _default_tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process default (tests inject a fresh ring)."""
    global _default_tracer
    with _default_lock:
        _default_tracer = tracer
    return tracer
