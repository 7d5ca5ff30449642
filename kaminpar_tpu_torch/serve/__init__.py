"""kaminpar_tpu_torch.serve: the partition-serving runtime (counterpart of
``kaminpar_tpu/serve/``).

A :class:`PartitionEngine` owns one long-lived warm device context:
ladder and k-range warmup at startup, a bounded async request queue with
admission control, deadlines and backpressure, micro-batches of
same-shape-cell requests run lane-stacked (kernels #1 and #3 over the
union of the lanes) with one-dispatch batch metrics, a crash-safe journal,
request traces, SLO burn rates and a Prometheus exposition.
``python -m kaminpar_tpu_torch.serve`` is the CLI (serve files, run the
synthetic demo load, or warm up and exit), on the card by default.  The
JAX package's ``PartitionFleet`` (one engine per device behind a router)
is not ported yet.
"""

from .batching import (
    PackedBatch,
    ShapeCell,
    batched_metrics,
    form_batches,
    pack_graphs,
    shape_cell,
    unpack_partition,
)
from .engine import PartitionEngine, ServeFuture, ServeRequest, ServeResult
from .errors import (
    CapacityError,
    DeadlineExceededError,
    EngineStoppedError,
    QueueFullError,
    RequestCancelledError,
    ServeError,
)
from .lanestack import LaneStackReport, LaneStackUnsupported, run_lanestacked
from .queue import BoundedServeQueue
from .stats import ServeStats

__all__ = [
    "BoundedServeQueue",
    "CapacityError",
    "DeadlineExceededError",
    "EngineStoppedError",
    "LaneStackReport",
    "LaneStackUnsupported",
    "PackedBatch",
    "PartitionEngine",
    "run_lanestacked",
    "QueueFullError",
    "RequestCancelledError",
    "ServeError",
    "ServeFuture",
    "ServeRequest",
    "ServeResult",
    "ServeStats",
    "ShapeCell",
    "batched_metrics",
    "form_batches",
    "pack_graphs",
    "shape_cell",
    "unpack_partition",
]
