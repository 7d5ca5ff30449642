"""Device-memory capacity planner and the serve admission preflight
(counterpart of ``kaminpar_tpu/telemetry/capacity.py``).

A closed-form model predicts the memory watermark of a (family, scale, k,
lanes, device_decode) cell against a per-device ceiling:

- *resident* bytes: exact array-size arithmetic over the padded shape
  ladder, the dense ``PaddedView`` and bucketed layout or the
  ``DeviceCompressedView`` (the JAX package's model, unchanged);
- *workspace*: the partition and label state the pipeline keeps between
  steps (unchanged);
- *temp*: the transient of the contraction, the binding one.  The JAX
  package reads it from XLA's ``memory_analysis`` of a shape-only
  lowering; the port has no such analysis, so it is a closed form of the
  bytes ``ops/contraction.py`` allocates per node and per edge, counted
  from that code (:data:`CONTRACTION_BYTES_PER_EDGE`,
  :data:`CONTRACTION_BYTES_PER_NODE`).  ``temp_model="fallback"`` takes
  the JAX package's fallback instead (24 B per edge), under which
  :func:`predict` equals the JAX package's on a process with no census;
- the coarse levels on top, by the hierarchy factor (unchanged).

Consumers: the serve engine's **admission preflight** (:func:`preflight`),
which rejects a request whose predicted watermark exceeds the engine's
ceiling with a typed ``CapacityError`` before it is queued, with host
integer arithmetic only (no device work, no readback); and the tests,
which hold the resident prediction to :data:`VALIDATION_TOLERANCE` of
``heap_profiler.live_array_bytes()``.  The device table holds the one card
the port targets, the H100 with 80 GB.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

#: Stated tolerance of the predicted-vs-measured resident validation on
#: CPU (tests/test_torch_serve_telemetry.py): the closed-form model must land within
#: this relative error of the constructed views' live-array bytes.
VALIDATION_TOLERANCE = 0.35

#: Device memory per card by device-kind substring (the card's public
#: specification).  CPU has no entry: ceilings there come from measured
#: allocator limits or explicit overrides only.
DEVICE_MEMORY_GIB = (
    ("h100", 80.0),
)

#: Fraction of the card's memory the planner budgets for the partitioner
#: (the rest covers the runtime, the caching allocator's fragmentation and
#: scratch; the JAX package's headroom).
DEFAULT_HEADROOM = 0.6

#: Directed-edge-per-node models per synthetic family at edge_factor ef
#: (generators.py semantics; rmat's dedup+symmetrize lands at ~0.87 of the
#: nominal 2*ef, measured across scales 12-16).
_FAMILY_M_PER_NODE = {
    "rmat": lambda ef: 2.0 * ef * 0.87,
    "rgg": lambda ef: 25.0,
    "grid": lambda ef: 4.0,
}

#: Compressed-stream bytes per directed edge by family (the JAX package's
#: table: rmat 9.8 weighted, rgg 4.6, grid 13.7; per-node decode metadata
#: dominates low-degree families).
_FAMILY_COMPRESSED_B_PER_EDGE = {"rmat": 9.8, "rgg": 4.6, "grid": 13.7}

#: The JAX package's fallback transient model (no census cell): the
#: sort-reduce contraction's working set, 3 int32 edge arrays in and the
#: sort scratch.
_TEMP_BYTES_PER_EDGE_FALLBACK = 24.0

#: The port's contraction transient per padded edge, counted from
#: ``ops/contraction.contract_device``/``contract_finish``: the edge arrays
#: alive at its peak are cu, cv (int32, 8 B), keep (bool, 1), ku, kv and the
#: sort order (int64, 24), su, sv (int64, 16), sw, rid, run_w (int32, 12),
#: first and valid (bool, 2): 63 B; the stable radix sort of the int64 key
#: with its int64 indices holds a double buffer of both (32 B); the finish
#: adds slot, out_u, out_v (int64, 24 B) while su, sv, rid, run_w, valid
#: (33 B) are still alive, below the sort's peak.
CONTRACTION_BYTES_PER_EDGE = 63 + 32

#: ... and per padded node: present, cmap, coarse_of, c_node_w, deg_c
#: (int32, 20 B), the labels' int64 copy for ``index_fill_`` (8), the
#: row_ptr's int64 zeros, cumsum and concatenation and its int32 copy
#: (20 B).
CONTRACTION_BYTES_PER_NODE = 20 + 8 + 20

_ITEM = 4  # int32 build; the 64-bit switch doubles edge arrays (noted)


def device_ceiling_bytes(device_kind: str,
                         headroom: float = DEFAULT_HEADROOM) -> Optional[int]:
    """Usable device-memory bytes per card for a device kind, after headroom; None
    for unknown kinds (CPU included — no static ceiling exists there)."""
    dk = (device_kind or "").lower()
    for key, gib in DEVICE_MEMORY_GIB:
        if key in dk:
            return int(gib * (1 << 30) * headroom)
    return None


def _next_bucket(x: int) -> int:
    from ..utils.intmath import next_shape_bucket

    return next_shape_bucket(max(int(x), 1), 256)


def family_shape(family: str, scale: int, edge_factor: int = 16):
    """(n, m_directed) estimate for a synthetic family at ``scale``
    (n = 2**scale; m from the per-family degree model)."""
    fam = family.lower()
    if fam not in _FAMILY_M_PER_NODE:
        raise ValueError(
            f"unknown family {family!r}; known: {sorted(_FAMILY_M_PER_NODE)}"
        )
    n = 1 << int(scale)
    m = int(n * _FAMILY_M_PER_NODE[fam](edge_factor))
    return n, m


# -- resident-buffer model ---------------------------------------------------


#: Slot inflation of the bucketed layout over m_pad when no degree data is
#: at hand: each row occupies its pow2 width class, so skewed families pay
#: 2-3x (rmat measured 2.0x at scale 16, 3.1x at scale 12 — the small-graph
#: end is worse because width classes are emptier).
DEFAULT_SLOT_FACTOR = 2.2


def _bucketed_layout_bytes(deg) -> int:
    """Exact byte count of the dense bucketed layout for a degree vector —
    the SAME width plan the layout build uses (graph/bucketed.node_width_plan:
    per-bucket (nodes + cols + wgts) at R_pad x w, heavy rows flat).  Pure
    host integer math over host degrees; never builds an array."""
    import numpy as np

    from ..graph.bucketed import node_width_plan
    from ..utils.intmath import next_pow2

    deg = np.asarray(deg, dtype=np.int64)
    bwidth, heavy_mask = node_width_plan(deg)
    total = 0
    for w in np.unique(bwidth[~heavy_mask]):
        R = int(((~heavy_mask) & (bwidth == w)).sum())
        R_pad = next_pow2(R, 8)
        total += R_pad * (2 * int(w) + 1)  # cols + wgts + nodes
    Hr = int(heavy_mask.sum())
    if Hr:
        Hs = int(deg[heavy_mask].sum())
        total += next_pow2(Hr + 1, 8) + 3 * next_pow2(Hs, 8)
    return total * _ITEM


def model_dense_resident_bytes(n_pad: int, m_pad: int, deg=None) -> int:
    """Padded dense adjacency tier: the PaddedView CSR (row_ptr + node_w +
    col/edge_w/edge_u) plus the bucketed layout's neighbor matrices and
    gather table.  With ``deg`` (a host degree vector) the bucketed term is
    exact — the same width plan the layout build runs; without it, the
    :data:`DEFAULT_SLOT_FACTOR` estimate covers the pow2 width classes."""
    csr = (2 * n_pad + 1 + 3 * m_pad) * _ITEM
    if deg is not None:
        bucketed = _bucketed_layout_bytes(deg) + n_pad * _ITEM
    else:
        slots = int(m_pad * DEFAULT_SLOT_FACTOR)
        bucketed = (2 * slots + n_pad) * _ITEM
    return csr + bucketed


def host_degrees(graph):
    """Host degree vector of a CSR graph WITHOUT a device transfer, or None
    when only a device row_ptr exists (generator/IO graphs carry a host
    copy; the preflight path falls back to the slot-factor model rather
    than pulling)."""
    import numpy as np

    rp = getattr(graph, "_host_row_ptr", None)
    return None if rp is None else np.diff(rp)


def model_compressed_resident_bytes(
    n_pad: int, m_pad: int, *, words: Optional[int] = None,
    weighted: bool = True, family: str = "rmat",
) -> int:
    """Compressed adjacency tier: packed gap words + (for weighted graphs)
    the uncompressed weight side stream + per-node decode metadata
    (word_start/width/degree/node_w + bucket rows ~ 5 ints/node + gather).
    ``words`` (exact packed word count, from a real ``CompressedGraph``)
    beats the per-family bytes/edge estimate when available."""
    node_meta = (4 + 5 + 1) * n_pad * _ITEM  # padded arrays+bucket rows+gather
    if words is not None:
        stream = _next_bucket(words + 1) * _ITEM
        side = m_pad * _ITEM if weighted else _ITEM
        return stream + side + node_meta
    # Family estimate: the JAX package's measured bytes/edge covers
    # stream + side stream + metadata; floor at the metadata term so sparse
    # families can't model below their per-node overhead.
    per_edge = _FAMILY_COMPRESSED_B_PER_EDGE.get(family.lower(), 9.8)
    return max(int(m_pad * per_edge), node_meta)


def model_workspace_bytes(n_pad: int, k: int, lanes: int = 1) -> int:
    """Between-dispatch pipeline state: labels/partition/best + LP label
    weights + moved masks ~ 6 int32 arrays of n_pad plus k-sized block
    tables, all multiplied by the vmapped lane count."""
    return lanes * (6 * n_pad + 4 * max(int(k), 2)) * _ITEM


def model_temp_bytes(n_pad: int, m_pad: int, temp_model: str = "contraction") -> int:
    """The transient of the worst single step: the port's contraction
    (``temp_model="contraction"``) or the JAX package's fallback
    (``"fallback"``).  Host arithmetic only."""
    if temp_model == "fallback":
        return int(m_pad * _TEMP_BYTES_PER_EDGE_FALLBACK)
    if temp_model != "contraction":
        raise ValueError(f"unknown temp_model {temp_model!r}")
    return int(m_pad * CONTRACTION_BYTES_PER_EDGE + n_pad * CONTRACTION_BYTES_PER_NODE)


#: Hierarchy factor: coarse levels' arrays sum geometrically on top of the
#: finest level (the JAX package's factor: at most 1.4x).
HIERARCHY_FACTOR = 1.4

#: Sharding pad tax of the dist tier (the JAX package's 1.3x over m/P).
SHARD_PAD_FACTOR = 1.3


@dataclass
class CapacityPrediction:
    """One cell's predicted watermark against a ceiling."""

    family: str
    scale: int
    k: int
    P: int = 1
    lanes: int = 1
    device_decode: bool = False
    n: int = 0
    m: int = 0
    n_pad: int = 0
    m_pad: int = 0
    resident_bytes: int = 0
    workspace_bytes: int = 0
    temp_bytes: int = 0
    hierarchy_bytes: int = 0
    predicted_peak_bytes: int = 0
    ceiling_bytes: Optional[int] = None
    device_kind: str = ""
    temp_source: str = "model"
    notes: List[str] = field(default_factory=list)

    @property
    def fits(self) -> Optional[bool]:
        if self.ceiling_bytes is None:
            return None
        return self.predicted_peak_bytes <= self.ceiling_bytes

    def to_dict(self) -> dict:
        out = {
            k: getattr(self, k)
            for k in (
                "family", "scale", "k", "P", "lanes", "device_decode",
                "n", "m", "n_pad", "m_pad", "resident_bytes",
                "workspace_bytes", "temp_bytes", "hierarchy_bytes",
                "predicted_peak_bytes", "ceiling_bytes", "device_kind",
                "temp_source", "notes",
            )
        }
        out["fits"] = self.fits
        return out


def predict(
    family: str = "rmat",
    scale: int = 16,
    k: int = 8,
    *,
    P: int = 1,
    lanes: int = 1,
    device_decode: bool = False,
    edge_factor: int = 16,
    device_kind: str = "",
    ceiling_bytes: Optional[int] = None,
    n: Optional[int] = None,
    m: Optional[int] = None,
    words: Optional[int] = None,
    weighted: bool = True,
    deg=None,
    temp_model: str = "contraction",
) -> CapacityPrediction:
    """Predicted per-device memory watermark of one workload cell.

    ``n``/``m`` override the family model (exact graph shapes); ``words``
    feeds the compressed model an exact packed stream length.  ``P`` > 1
    models the sharded dist tier (per-shard slices + the pad
    tax); ``lanes`` > 1 the lane-stacked serve pipeline (workspace and
    adjacency replicate per lane).
    """
    if n is None or m is None:
        fn, fm = family_shape(family, scale, edge_factor)
        n = fn if n is None else n
        m = fm if m is None else m
    P = max(int(P), 1)
    lanes = max(int(lanes), 1)
    # Per-shard slice on the mesh (+ pad tax); lanes stack whole graphs.
    m_dev = int(m / P * (SHARD_PAD_FACTOR if P > 1 else 1.0)) * lanes
    n_dev = int(n / P * (SHARD_PAD_FACTOR if P > 1 else 1.0)) * lanes
    n_pad = _next_bucket(n_dev)
    m_pad = _next_bucket(m_dev)
    if device_decode:
        resident = model_compressed_resident_bytes(
            n_pad, m_pad, words=words, weighted=weighted, family=family
        )
    else:
        resident = model_dense_resident_bytes(
            n_pad, m_pad, deg=deg if P == 1 and lanes == 1 else None
        )
    workspace = model_workspace_bytes(n_pad, k, lanes=1)  # lanes in n_pad
    temp = model_temp_bytes(n_pad, m_pad, temp_model)
    hierarchy = int((resident + workspace) * (HIERARCHY_FACTOR - 1.0))
    peak = resident + workspace + hierarchy + temp
    pred = CapacityPrediction(
        family=family, scale=int(scale), k=int(k), P=P, lanes=lanes,
        device_decode=bool(device_decode), n=int(n), m=int(m),
        n_pad=n_pad, m_pad=m_pad, resident_bytes=int(resident),
        workspace_bytes=int(workspace), temp_bytes=int(temp),
        hierarchy_bytes=int(hierarchy), predicted_peak_bytes=int(peak),
        device_kind=device_kind,
        temp_source=f"model:{temp_model}",
    )
    if ceiling_bytes is not None:
        pred.ceiling_bytes = int(ceiling_bytes)
    elif device_kind:
        pred.ceiling_bytes = device_ceiling_bytes(device_kind)
    if P > 1:
        pred.notes.append(
            f"per-shard slice with {SHARD_PAD_FACTOR}x pad tax"
        )
    return pred


def predict_for_graph(graph, k: int, *, device_decode: bool = False,
                      lanes: int = 1, device_kind: str = "",
                      ceiling_bytes: Optional[int] = None) -> CapacityPrediction:
    """Prediction for a concrete in-memory graph (exact n/m, and the exact
    bucketed layout when the graph carries a host row_ptr): the serve
    preflight's path, host integer arithmetic only."""
    return predict(
        "rmat", 0, k, lanes=lanes, device_decode=device_decode,
        device_kind=device_kind, ceiling_bytes=ceiling_bytes,
        n=int(graph.n), m=int(graph.m), deg=host_degrees(graph),
    )


def ladder(
    family: str = "rmat",
    k: int = 64,
    *,
    device_kind: str = "NVIDIA H100 80GB HBM3",
    scales=range(16, 31),
    P: int = 1,
    lanes: int = 1,
    edge_factor: int = 16,
    ceiling_bytes: Optional[int] = None,
) -> dict:
    """The fit/no-fit ladder over ``scales`` for the dense and
    device-decode arms, plus the max feasible scale of each (the ``tools
    capacity`` payload)."""
    rows = []
    max_fit = {"dense": None, "device_decode": None}
    for s in scales:
        row = {}
        for arm, dd in (("dense", False), ("device_decode", True)):
            pred = predict(
                family, s, k, P=P, lanes=lanes, device_decode=dd,
                edge_factor=edge_factor, device_kind=device_kind,
                ceiling_bytes=ceiling_bytes,
            )
            row[arm] = pred
            if pred.fits:
                max_fit[arm] = s
        rows.append(row)
    return {
        "family": family, "k": k, "P": P, "lanes": lanes,
        "device_kind": device_kind,
        "ceiling_bytes": rows[0]["dense"].ceiling_bytes if rows else None,
        "rows": rows,
        "max_feasible_scale": max_fit,
    }


# -- CPU validation (tests/test_torch_serve_telemetry.py) --------------------


def validate_cpu(scale: int = 12, edge_factor: int = 16, seed: int = 1) -> dict:
    """Predicted against measured resident bytes of the dense arm on the
    CPU: the live-tensor delta of building a graph's padded view and
    bucketed layout (``heap_profiler.live_array_bytes``).  Returns
    {predicted_bytes, measured_bytes, rel_err}; the tests hold rel_err to
    :data:`VALIDATION_TOLERANCE`."""
    from ..graph.generators import rmat_graph
    from ..utils import heap_profiler

    g = rmat_graph(int(scale), edge_factor=int(edge_factor), seed=int(seed))
    before = heap_profiler.live_array_bytes()
    pv = g.padded()
    bv = g.bucketed()
    measured = heap_profiler.live_array_bytes() - before
    pred = model_dense_resident_bytes(pv.n_pad, pv.m_pad, deg=host_degrees(g))
    del bv
    return {
        "scale": int(scale), "n": int(g.n), "m": int(g.m),
        "tolerance": VALIDATION_TOLERANCE,
        "watermark_backend": heap_profiler.watermark_backend(),
        "predicted_bytes": int(pred),
        "measured_bytes": int(measured),
        "rel_err": round(abs(pred - measured) / max(measured, 1), 4),
    }


# -- serve admission preflight ----------------------------------------------


def preflight(graph, k: int, *, ceiling_bytes: int, device_kind: str = "",
              device_decode: bool = False, lanes: int = 1):
    """Admission preflight of one serve request: predict the watermark and
    raise ``serve.errors.CapacityError`` when it exceeds the ceiling,
    before the engine queues anything.  Host arithmetic only: no device
    work, no readback."""
    pred = predict_for_graph(
        graph, k, device_decode=device_decode, lanes=lanes,
        device_kind=device_kind, ceiling_bytes=ceiling_bytes,
    )
    if pred.fits is False:
        from ..serve.errors import CapacityError

        raise CapacityError(
            predicted_bytes=pred.predicted_peak_bytes,
            ceiling_bytes=int(ceiling_bytes),
            cell=(pred.n_pad, pred.m_pad, int(k)),
            device_kind=device_kind,
        )
    return pred


def format_bytes(b: Optional[int]) -> str:
    if b is None:
        return "?"
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if b >= div:
            return f"{b / div:.2f} {unit}"
    return f"{b} B"
