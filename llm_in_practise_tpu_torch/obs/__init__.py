"""Observability (port of ``llm_in_practise_tpu/obs``, first part):
coordinator-gated logging, the metrics registry every server renders
``/metrics`` through, the card's memory telemetry and the HBM ledger
(``GET /debug/hbm``). The tracer, meters, step timeline, cost model,
profiler capture, build info and debug helpers are ROADMAP.md queue A
item 6's second part.
"""

from llm_in_practise_tpu_torch.obs.cost import (  # noqa: F401
    device_memory_stats,
    hbm_stats,
    tree_bytes,
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
from llm_in_practise_tpu_torch.obs.registry import (  # noqa: F401
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    HistogramAccumulator,
    Registry,
)
