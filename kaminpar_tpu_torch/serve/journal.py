"""Crash-safe serve journal (counterpart of ``kaminpar_tpu/serve/journal.py``;
its records are the JSON the JAX package writes, key for key).

An append-only JSONL record of the engine's accepted work: every
admitted request writes an **admit** record (request params + the graph
payload, serialized host-side through the same ONE-counted-pull
``graph_to_host`` discipline as the pipeline, under the
``journal_write`` phase) and every first-wins future finalization
writes a **resolution** record.  fsync is batched (``fsync_every``
appends) — the un-fsynced suffix is the crash-loss window; resolutions
and the warm-state record force an fsync so a recorded outcome is
durable before its caller can act on it.

On restart, :meth:`PartitionEngine.start` replays the journal:

* admits with **no** resolution record are re-enqueued idempotently
  (``journal_replay`` phase; the replay bypasses the admission bound —
  the work was admitted once already) and resolve into fresh resolution
  records, so restart mid-burst loses ZERO accepted requests and the
  final journal carries exactly one resolution per admit
  (duplicates are impossible: only unresolved entries replay, and the
  engine's first-wins future finalization already dedupes in-process);
* the latest **warm_state** record restores the warmup report, warm
  cells, lane-stack layout keys, service-time EMA seed, and open
  breaker trips through the warm-state inheritance path — the restarted
  replica skips the warmup passes of every restored cell.

A torn trailing line (a kill mid-append) is tolerated and counted, not
fatal.  Rejections that mean "the engine gave the request back"
(EngineStoppedError / WorkerHung — the resteerable classes) are NOT
journaled as resolutions: they leave the entry replayable, which is the
whole point of the journal.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

import numpy as np


def _b64(arr: np.ndarray) -> dict:
    import base64

    arr = np.ascontiguousarray(arr)
    return {
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "b64": base64.b64encode(arr.tobytes()).decode("ascii"),
    }


def _unb64(payload: dict) -> np.ndarray:
    import base64

    return np.frombuffer(
        base64.b64decode(payload["b64"]), dtype=np.dtype(payload["dtype"])
    ).reshape(payload["shape"]).copy()


def encode_graph(graph) -> dict:
    """Host-serialize a CSR graph for an admit record — ONE counted bulk
    pull (``graph_to_host``); the caller scopes it under the
    ``journal_write`` phase."""
    from ..partitioning.kway import graph_to_host

    host = graph_to_host(graph)
    return {
        "n": int(graph.n),
        "m": int(graph.m),
        "row_ptr": _b64(host.row_ptr),
        "col_idx": _b64(host.col_idx),
        "node_w": _b64(host.node_w),
        "edge_w": _b64(host.edge_w),
    }


def decode_graph(payload: dict, device="cpu"):
    """Rebuild the CSR graph of an admit record on ``device`` (host to
    device copies only; same n/m, so the same shape-ladder buckets as the
    original admission)."""
    from ..graph.csr import from_numpy_csr

    return from_numpy_csr(
        _unb64(payload["row_ptr"]), _unb64(payload["col_idx"]),
        _unb64(payload["node_w"]), _unb64(payload["edge_w"]),
        device=device,
    )


def _to_tuple(obj):
    """JSON round-trips tuples into lists; warm-state keys are tuples."""
    if isinstance(obj, list):
        return tuple(_to_tuple(x) for x in obj)
    return obj


class ServeJournal:
    """One engine's append-only journal file (thread-safe appends,
    batched fsync)."""

    def __init__(self, path: str, fsync_every: int = 8):
        self.path = path
        self.fsync_every = max(1, int(fsync_every))
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")  # noqa: SIM115 — held
        self._lock = threading.Lock()
        self._since_fsync = 0
        self.appended = 0
        self.fsyncs = 0
        self._closed = False

    def append(self, record: dict, force_fsync: bool = False) -> None:
        line = json.dumps(record, separators=(",", ":"), default=str)
        with self._lock:
            if self._closed:
                return
            self._f.write(line + "\n")
            self._f.flush()
            self.appended += 1
            self._since_fsync += 1
            if force_fsync or self._since_fsync >= self.fsync_every:
                os.fsync(self._f.fileno())
                self._since_fsync = 0
                self.fsyncs += 1

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
                self.fsyncs += 1
            finally:
                self._f.close()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "appended": self.appended,
                "fsyncs": self.fsyncs,
                "fsync_every": self.fsync_every,
            }


def read_journal(path: str) -> dict:
    """Parse a journal file into its recovery view:

    ``unresolved`` — admit records (in admit order) with no matching
    resolution; ``resolved`` — journal ids with a resolution record (and
    how many — replay conservation asserts exactly one each);
    ``warm_state`` — the LATEST warm-state record; ``torn`` — trailing
    lines that did not parse (a kill mid-append)."""
    admits: Dict[int, dict] = {}
    resolved: Dict[int, int] = {}
    warm_state: Optional[dict] = None
    order: List[int] = []
    torn = 0
    if not os.path.exists(path):
        return {"unresolved": [], "resolved": {}, "warm_state": None,
                "torn": 0, "admits": 0, "max_id": 0}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                torn += 1
                continue
            kind = rec.get("t")
            if kind == "admit":
                jid = int(rec["id"])
                admits[jid] = rec
                order.append(jid)
            elif kind == "resolve":
                jid = int(rec["id"])
                resolved[jid] = resolved.get(jid, 0) + 1
            elif kind == "warm_state":
                warm_state = rec  # latest wins
    unresolved = [admits[j] for j in order if j not in resolved]
    return {
        "unresolved": unresolved,
        "resolved": resolved,
        "warm_state": warm_state,
        "torn": torn,
        "admits": len(admits),
        # Journal ids are engine request ids; a restarted engine resumes
        # its counter PAST them so a new admission can never collide with
        # a dead run's journal entry.
        "max_id": max(list(admits) + list(resolved), default=0),
    }


def compact(path: str) -> int:
    """Rewrite the journal down to what a future recovery needs — the
    unresolved admits (in admit order) and the LATEST warm-state record —
    with the same atomic-rename discipline as the checkpoint writer.
    Called at clean engine shutdown: without it an append-only journal
    grows one graph payload per request forever and every restart
    re-parses the whole history.  Returns how many records were dropped.
    A crash mid-compaction leaves the original file intact."""
    view = read_journal(path)
    keep: List[dict] = list(view["unresolved"])
    if view["warm_state"] is not None:
        keep.append(view["warm_state"])
    try:
        with open(path, encoding="utf-8") as f:
            total = sum(1 for line in f if line.strip())
    except OSError:
        return 0
    dropped = total - len(keep)
    if dropped <= 0:
        return 0
    tmp = path + f".compact{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        for rec in keep:
            f.write(json.dumps(rec, separators=(",", ":"), default=str)
                    + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return dropped


# ---------------------------------------------------------------------------
# Warm-state round trip (the warm-state inheritance path, serialized)
# ---------------------------------------------------------------------------


def warm_state_record(engine) -> dict:
    """Serialize the engine's warm state: warmup-report rows, warm cells
    / (n, k, tier) pairs / lane-stack layout keys, the service-time EMA,
    and which breaker cells are currently tripped open."""
    open_breakers = []
    snap = engine.breakers.snapshot()
    for name, br in snap["breakers"].items():
        if br["state"] != "closed":
            path, _, cell = name.partition("|")
            open_breakers.append(
                [path, [_int_or_str(c) for c in cell.split(",") if c != ""]]
            )
    return {
        "t": "warm_state",
        "warmup_report": list(engine.warmup_report),
        "warm_cells": [list(c) for c in engine._warm_cells],
        "warm_nk": [list(c) for c in engine._warm_nk],
        "warm_stack_keys": [list(c) for c in engine._warm_stack_keys],
        "ema_service_s": engine.stats_.service_time_estimate(),
        "open_breakers": open_breakers,
    }


def _int_or_str(text: str):
    try:
        return int(text)
    except ValueError:
        return text


def apply_warm_state(engine, record: dict) -> int:
    """Restore a warm-state record into a not-yet-started engine.  Rows land
    marked ``inherited`` (the cost was paid by the dead process), warm
    sets are seeded so ``start(warmup=True)`` skips every restored cell,
    the EMA seeds the retry-after estimate, and
    open breaker cells are re-tripped fresh (the cooldown restarts: the
    dead process's clock is meaningless here)."""
    from .batching import ShapeCell

    restored = 0
    for row in record.get("warmup_report", []):
        row = dict(row)
        row["inherited"] = True
        row["wall_s"] = 0.0
        row["backend_compile_s"] = 0.0
        row["trace_s"] = 0.0
        engine.warmup_report.append(row)
        restored += 1
    for cell in record.get("warm_cells", []):
        engine._warm_cells.add(ShapeCell(*[int(x) for x in cell]))
    for nk in record.get("warm_nk", []):
        engine._warm_nk.add((int(nk[0]), int(nk[1]), str(nk[2])))
    for key in record.get("warm_stack_keys", []):
        engine._warm_stack_keys.add(_to_tuple(key))
    ema = float(record.get("ema_service_s", 0.0) or 0.0)
    if ema > 0.0:
        engine.stats_.seed_service_time(ema)
    for path, cell in record.get("open_breakers", []):
        engine.breakers.get(str(path), tuple(cell)).trip()
    if restored or record.get("warm_cells"):
        engine._inherited = True
    return restored
