"""Observability (port of ``llm_in_practise_tpu/obs``): coordinator-gated
logging, the metrics registry every server renders ``/metrics`` through,
the request-span tracer (:mod:`.trace`, ``GET /debug/traces``), the
per-step host timeline (:mod:`.steptrace`), the device plane (the FLOP /
byte cost model of :mod:`.cost`, the dispatch and goodput meters of
:mod:`.meter`, on-demand ``torch.profiler`` capture and compile telemetry
in :mod:`.prof`), the build identity (:mod:`.buildinfo`), the debug aids
(:mod:`.debug`), the card's memory telemetry and the HBM ledger
(``GET /debug/hbm``). The fleet rollup of the JAX package's
``obs/fleet.py`` is ROADMAP.md queue A item 12.
"""

from llm_in_practise_tpu_torch.obs.buildinfo import (  # noqa: F401
    build_info,
    config_fingerprint,
    register_build_info,
)
from llm_in_practise_tpu_torch.obs.cost import (  # noqa: F401
    CostModel,
    chip_hbm_bw,
    chip_peak,
    device_memory_stats,
    flops_per_token,
    hbm_stats,
    matmul_param_count,
    tree_bytes,
)
from llm_in_practise_tpu_torch.obs.debug import (  # noqa: F401
    disable_debug,
    enable_debug,
    seed_everything,
    tap,
)
from llm_in_practise_tpu_torch.obs.hbm import (  # noqa: F401
    HbmLedger,
    get_ledger,
    host_entry_bytes,
    register_hbm_ledger,
)
from llm_in_practise_tpu_torch.obs.logging import (  # noqa: F401
    get_logger,
    setup_logging,
)
from llm_in_practise_tpu_torch.obs.meter import (  # noqa: F401
    DispatchMeter,
    EpochTimer,
    GoodputMeter,
    HandoffMeter,
    RollingMean,
    Throughput,
    profile_trace,
)
from llm_in_practise_tpu_torch.obs.prof import (  # noqa: F401
    CompileMeter,
    ProfilerCapture,
    get_profiler,
)
from llm_in_practise_tpu_torch.obs.registry import (  # noqa: F401
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    HistogramAccumulator,
    Registry,
)
from llm_in_practise_tpu_torch.obs.steptrace import (  # noqa: F401
    ACTIVITIES as STEPTRACE_ACTIVITIES,
)
from llm_in_practise_tpu_torch.obs.steptrace import StepTrace  # noqa: F401
from llm_in_practise_tpu_torch.obs.trace import (  # noqa: F401
    TraceContext,
    Tracer,
    format_traceparent,
    get_tracer,
    parse_traceparent,
    set_tracer,
)
