"""Metrics registry: one Prometheus exposition renderer (port of
``llm_in_practise_tpu/obs/registry.py``, stdlib only).

- :class:`Counter` / :class:`Gauge` / :class:`Histogram`: labeled,
  thread-safe instruments.
- **Callback-backed families** (:meth:`Registry.counter_func`,
  :meth:`Registry.gauge_func`, :meth:`Registry.histogram_func`): the
  serving stack's live objects keep their plain attributes and the
  registry reads them at scrape time, so no count is kept twice.
- :meth:`Registry.render`: a ``# TYPE`` line for every family, escaped
  label values, ``_bucket``/``_count``/``_sum`` consistency for
  histograms, integral values rendered without a decimal point.
- :class:`HistogramAccumulator`: a fixed-bucket histogram with O(1)
  memory.
- :meth:`Registry.family_names`: the name census a doc check walks
  (every family must appear in ``docs/observability.md``'s catalog).

Strictness contract: every sample belongs to a declared family, label
values are escaped per the exposition spec (``\\`` ``\"`` ``\n``),
histogram bucket counts are cumulative and end at ``+Inf`` == ``_count``.
"""

from __future__ import annotations

import bisect
import math
import threading

# Latency buckets shared by the serving histograms (seconds), from
# sub-millisecond local work to multi-second remote calls.
LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def format_value(v) -> str:
    """Exposition value: integral floats render as ints (``5`` not
    ``5.0``) so counter lines match their historical hand-formatted
    shape; everything else uses repr (full precision)."""
    f = float(v)
    if math.isnan(f):
        raise ValueError("NaN is not a valid exposition value")
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def escape_label_value(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def format_labels(labels: dict) -> str:
    """``{k="v",...}`` (insertion order — per-upstream series pin their
    label order and dashboards/tests match on the exact string), or
    ``""`` for the unlabeled child."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def bucket_label(bound: float) -> str:
    if bound == float("inf"):
        return "+Inf"
    return format_value(bound)


class HistogramAccumulator:
    """Fixed-bucket histogram: O(1) memory however many observations.

    ``counts[i]`` is the number of observations in ``(buckets[i-1],
    buckets[i]]`` (non-cumulative internally; :meth:`snapshot` returns
    the cumulative Prometheus form). Thread-safe.
    """

    def __init__(self, buckets=LATENCY_BUCKETS_S):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        # +1 = overflow bin
        self._counts = [0] * (len(self.buckets) + 1)  # guarded-by: _lock
        self.count = 0    # guarded-by: _lock
        self.sum = 0.0    # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v

    def snapshot(self) -> tuple[tuple[float, ...], tuple[int, ...], int, float]:
        """(bounds incl +Inf, cumulative counts, count, sum)."""
        with self._lock:
            counts = list(self._counts)
            count, total = self.count, self.sum
        cum, running = [], 0
        for c in counts:
            running += c
            cum.append(running)
        return (self.buckets + (float("inf"),), tuple(cum), count, total)

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (introspection/benches;
        the scrape path exports buckets and lets PromQL do this)."""
        bounds, cum, count, _ = self.snapshot()
        if count == 0:
            return 0.0
        rank = q * count
        prev_bound, prev_cum = 0.0, 0
        for bound, c in zip(bounds, cum):
            if c >= rank:
                if bound == float("inf"):
                    return prev_bound
                span = c - prev_cum
                frac = (rank - prev_cum) / span if span else 1.0
                return prev_bound + frac * (bound - prev_bound)
            prev_bound, prev_cum = (bound, c)
        return self.buckets[-1]


class _Family:
    """One metric family: name, kind, and a ``collect()`` returning
    ``[(labels_dict, value)]`` (histograms return snapshots)."""

    def __init__(self, name: str, kind: str, help: str = ""):
        _validate_name(name)
        self.name = name
        self.kind = kind
        self.help = help

    def collect(self):  # pragma: no cover - abstract
        raise NotImplementedError


def _validate_name(name: str) -> None:
    import re

    if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", name):
        raise ValueError(f"invalid metric name {name!r}")


def _label_key(labelnames, kw) -> tuple:
    if set(kw) != set(labelnames):
        raise ValueError(
            f"labels {sorted(kw)} do not match declared {list(labelnames)}")
    return tuple(kw[k] for k in labelnames)


class _ValueChild:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self.value -= n

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class _ChildFamily(_Family):
    def __init__(self, name, kind, help="", labelnames=()):
        super().__init__(name, kind, help)
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, object] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        if not self.labelnames:
            # eager unlabeled child: a histogram scraped before its
            # first observe() must render zero-filled buckets, not a
            # bare # TYPE line (which the strict parser rejects), and
            # counters/gauges conventionally expose 0 from birth
            self._children[()] = self._new_child()

    def _new_child(self):
        return _ValueChild()

    def labels(self, **kw):
        key = _label_key(self.labelnames, kw)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled; use .labels(...) first")
        return self.labels()

    def collect(self):
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, key)), child)
                for key, child in items]


class Counter(_ChildFamily):
    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, "counter", help, labelnames)

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_ChildFamily):
    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, "gauge", help, labelnames)

    def set(self, v: float) -> None:
        self._default().set(v)

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_ChildFamily):
    def __init__(self, name, help="", labelnames=(),
                 buckets=LATENCY_BUCKETS_S):
        # before super().__init__: the eager unlabeled child calls
        # _new_child(), which reads self.buckets
        self.buckets = tuple(sorted(float(b) for b in buckets))
        super().__init__(name, "histogram", help, labelnames)

    def _new_child(self):
        return HistogramAccumulator(self.buckets)

    def observe(self, v: float) -> None:
        self._default().observe(v)


class _FuncFamily(_Family):
    """Scrape-time family over live objects: ``fn`` returns a scalar
    (unlabeled) or an iterable of ``(labels_dict, value)``. Values are
    read at render — the owners keep their plain attributes."""

    def __init__(self, name, kind, fn, help=""):
        super().__init__(name, kind, help)
        self._fn = fn

    def collect(self):
        got = self._fn()
        if isinstance(got, (int, float)):
            return [({}, got)]
        return [(dict(labels), value) for labels, value in got]


class Registry:
    """A set of metric families with one canonical text renderer."""

    def __init__(self):
        self._families: list[_Family] = []  # guarded-by: _lock
        self._lock = threading.Lock()

    def register(self, family: _Family):
        with self._lock:
            if any(f.name == family.name for f in self._families):
                raise ValueError(
                    f"duplicate metric family {family.name!r}")
            self._families.append(family)
        return family

    def family_names(self) -> frozenset:
        """Names of every registered family: the doc check walks the
        servers' registries through this and fails when a family is
        missing from docs/observability.md's catalog."""
        with self._lock:
            return frozenset(f.name for f in self._families)

    # -- instrument constructors ---------------------------------------------

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self.register(Counter(name, help, labelnames))

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self.register(Gauge(name, help, labelnames))

    def histogram(self, name, help="", labelnames=(),
                  buckets=LATENCY_BUCKETS_S) -> Histogram:
        return self.register(Histogram(name, help, labelnames, buckets))

    # -- callback-backed families (migration path for live counters) ---------

    def counter_func(self, name, fn, help=""):
        return self.register(_FuncFamily(name, "counter", fn, help))

    def gauge_func(self, name, fn, help=""):
        return self.register(_FuncFamily(name, "gauge", fn, help))

    def histogram_func(self, name, fn, help=""):
        """``fn`` returns ``[(labels, HistogramAccumulator-or-snapshot)]``."""
        return self.register(_FuncFamily(name, "histogram", fn, help))

    # -- rendering ------------------------------------------------------------

    def render(self) -> str:
        with self._lock:
            families = list(self._families)
        lines: list[str] = []
        for fam in families:
            if fam.help:
                lines.append(f"# HELP {fam.name} "
                             + fam.help.replace("\\", "\\\\")
                             .replace("\n", "\\n"))
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labels, value in fam.collect():
                if fam.kind == "histogram":
                    lines.extend(self._render_histogram(fam.name, labels,
                                                        value))
                else:
                    v = getattr(value, "value", value)
                    lines.append(
                        f"{fam.name}{format_labels(labels)} "
                        f"{format_value(v)}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def _render_histogram(name, labels, acc) -> list[str]:
        snap = acc.snapshot() if hasattr(acc, "snapshot") else acc
        bounds, cum, count, total = snap
        out = []
        for bound, c in zip(bounds, cum):
            ble = dict(labels)
            ble["le"] = bucket_label(bound)
            out.append(f"{name}_bucket{format_labels(ble)} "
                       f"{format_value(c)}")
        lbl = format_labels(labels)
        out.append(f"{name}_count{lbl} {format_value(count)}")
        out.append(f"{name}_sum{lbl} {format_value(total)}")
        return out
