"""Level-boundary checkpoints of the deep pipeline and bit-identical resume
(counterpart of ``kaminpar_tpu/resilience/checkpoint.py``).

A run of the deep pipeline is deterministic given its graph, its context
and its random streams, so its state at a coarsening or uncoarsening
**level boundary** is enough to finish it as the uninterrupted run would:

* the level stack: every coarse level's CSR arrays and its fine-to-coarse
  map.  A level does not change once contracted, so each is pulled once
  (5 counted pulls under ``checkpoint_write``) and cached on the host,
  with its cached scalars (max node weight, total node and edge weight),
  so that restore reads nothing back;
* the current partition and block count (uncoarsening boundaries; one
  pull each);
* the random streams' chain position (``utils/rng.py``): the seed, the
  host generator's state and each device generator's state;
* a fingerprint of the problem (n, m, k, epsilon, seed, mode,
  ``use_64bit_ids``, a digest of the result-relevant knobs, and the
  device type) that resume checks; the preset name and git head are
  advisory;
* the readback census at the boundary, for the record.

The port's graphs carry no degree histogram and no degree-sorted flag, so
a level costs 5 pulls, never the JAX package's sixth, and its meta holds
neither.  The device type is a strict field of the port's own: a CUDA
generator's state does not restore into a CPU generator, so a checkpoint
written on the card is rejected on the CPU (and the other way round)
instead of going on, silently, on other random streams.

Writes are atomic (a temporary file, fsync, rename): a kill at any moment
leaves the previous or the new checkpoint whole.  Arming:
``Context.resilience.checkpoint_dir`` or ``KPTPU_CHECKPOINT`` (with
``KPTPU_CHECKPOINT_EVERY``).  Disarmed, the pipeline makes no
``checkpoint_write`` pull (asserted in ``partitioning/deep.py`` when the
budgets are armed).

Resume: ``KaMinPar.compute_partition(resume=path_or_dir)`` checks the
fingerprint, rebuilds the level stack on the facade's device with
host-to-device copies only (no pull, and on the card no synchronizing
copy: the arrays go through pinned memory), restores the random streams
and goes on.  The envelope is the facade's top-level DEEP run on a dense
input; armed outside it, the writer warns once and the run goes
un-checkpointed.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
import os
import re
import warnings
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..utils import sync_stats
from ..utils.logger import Logger

_FILE_RE = re.compile(r"^ckpt_deep_b(\d+)\.npz$")
_VERSION = 1
_LEVEL_ARRAYS = ("rp", "ci", "nw", "ew", "co")


class CheckpointMismatchError(ValueError):
    """The checkpoint's fingerprint does not match the resuming run:
    resuming would give a partition of a different problem."""


def resolve_dir(resilience) -> Optional[str]:
    """The armed checkpoint directory (``KPTPU_CHECKPOINT`` outranks
    ``checkpoint_dir``), or None when disarmed."""
    path = os.environ.get("KPTPU_CHECKPOINT", "") or getattr(resilience, "checkpoint_dir", "")
    return path or None


def _every(resilience) -> int:
    env = os.environ.get("KPTPU_CHECKPOINT_EVERY", "")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            warnings.warn(f"kaminpar_tpu_torch checkpoint: unparseable "
                          f"KPTPU_CHECKPOINT_EVERY={env!r} ignored", RuntimeWarning)
    return max(1, int(getattr(resilience, "checkpoint_every_levels", 1) or 1))


def _git_head() -> str:
    """The git head of the working directory's repository, read from its
    files (a checkpoint write starts no process); "" outside one."""
    d = os.getcwd()
    for _ in range(16):
        head = os.path.join(d, ".git", "HEAD")
        if os.path.isfile(head):
            try:
                with open(head, encoding="utf-8") as f:
                    text = f.read().strip()
                if text.startswith("ref:"):
                    ref = os.path.join(d, ".git", *text[4:].strip().split("/"))
                    if os.path.isfile(ref):
                        with open(ref, encoding="utf-8") as f:
                            return f.read().strip()
                return text
            except OSError:
                return ""
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return ""


def _plain(obj):
    """A JSON-able copy of a context subtree (enums by value)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_plain(x) for x in obj]
    return obj


def knobs_digest(ctx) -> str:
    """Digest of the result-relevant knob subtrees, the JAX package's:
    mode, ids, v-cycles and the coarsening, initial-partitioning,
    refinement and compression trees (the partition tree's k and epsilon
    are fingerprint fields of their own; the runtime-only trees change no
    partition)."""
    picked = {key: _plain(getattr(ctx, key)) for key in (
        "mode", "use_64bit_ids", "vcycles", "restrict_vcycle_refinement",
        "coarsening", "initial_partitioning", "refinement", "compression")}
    blob = json.dumps(picked, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def fingerprint(ctx, graph) -> dict:
    import torch

    return {
        "graph_n": int(graph.n),
        "graph_m": int(graph.m),
        "k": int(ctx.partition.k),
        "epsilon": float(ctx.partition.epsilon),
        "seed": int(ctx.seed),
        "mode": str(ctx.mode.value),
        "use_64bit_ids": bool(ctx.use_64bit_ids),
        "knobs_digest": knobs_digest(ctx),
        "device": torch.device(graph.device).type,
        "preset": str(ctx.preset_name),
        "git_head": _git_head(),
    }


#: fingerprint fields that must match for a resume; the others only warn
STRICT_FIELDS = ("graph_n", "graph_m", "k", "epsilon", "seed", "mode", "use_64bit_ids",
                 "knobs_digest", "device")
ADVISORY_FIELDS = ("git_head", "preset")


@dataclass
class CheckpointState:
    """One loaded checkpoint (see :func:`load`)."""

    stage: str                      # "coarsening" | "uncoarsening"
    num_levels: int
    cur_k: int
    partition: Optional[np.ndarray]
    levels: List[dict]              # [{rp, ci, nw, ew, co, meta}, ...]
    rng: dict                       # utils/rng chain position
    contractions: int
    boundary: int
    fingerprint: dict
    meta: dict = field(default_factory=dict)
    path: str = ""


def validate_fingerprint(state: CheckpointState, ctx, graph) -> None:
    """Raise :class:`CheckpointMismatchError` when the checkpoint was taken
    of another problem (a strict field differs); warn when only the preset
    name or the git head changed: the knob digest governs the result."""
    want = fingerprint(ctx, graph)
    have = state.fingerprint
    diffs = {key: (have.get(key), want[key]) for key in STRICT_FIELDS
             if have.get(key) != want[key]}
    if diffs:
        raise CheckpointMismatchError(
            "checkpoint fingerprint mismatch (checkpoint vs this run): "
            + ", ".join(f"{k}={a!r} vs {b!r}" for k, (a, b) in sorted(diffs.items())))
    for key in ADVISORY_FIELDS:
        if have.get(key) != want[key]:
            warnings.warn(
                f"kaminpar_tpu_torch checkpoint: {key} changed since the checkpoint "
                f"({have.get(key)!r} -> {want[key]!r}); the knob digest matches, so "
                "resume proceeds", RuntimeWarning)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class CheckpointWriter:
    """The boundary writer of one deep run.  Each coarse level is pulled
    once (5 counted pulls under ``checkpoint_write``) and cached on the
    host; an uncoarsening boundary adds one partition pull.
    ``pull_budget`` sums this exact entitlement, which the deep scheme
    asserts.  ``writes`` lists (boundary, stage, seconds, bytes) per file,
    and each write logs one line with them."""

    def __init__(self, directory: str, every: int, keep_all: bool, fp: dict):
        self.dir = directory
        self.every = max(1, int(every))
        self.keep_all = bool(keep_all)
        self.fingerprint = fp
        self.boundary = 0
        self.pull_budget = 0
        self.writes: List[dict] = []
        self._levels: List[dict] = []
        self._last_path: Optional[str] = None
        os.makedirs(self.dir, exist_ok=True)

    def seed_from_state(self, state: CheckpointState) -> None:
        """Resume: take over the loaded state's host levels (no pull) and
        its boundary numbering."""
        self._levels = [dict(lv) for lv in state.levels]
        self.boundary = int(state.boundary)

    def on_coarsen_level(self, coarsener) -> None:
        self.boundary += 1
        if self.boundary % self.every:
            return
        self._ensure_levels(coarsener)
        self._write("coarsening", coarsener, partition=None, cur_k=0)

    def on_uncoarsen_boundary(self, coarsener, p_graph, cur_k: int) -> None:
        self.boundary += 1
        if self.boundary % self.every:
            return
        self._ensure_levels(coarsener)
        part = sync_stats.pull(p_graph.partition, phase="checkpoint_write")
        self.pull_budget += 1
        self._write("uncoarsening", coarsener, partition=np.asarray(part, dtype=np.int32),
                    cur_k=int(cur_k))

    def _ensure_levels(self, coarsener) -> None:
        hier = coarsener.hierarchy
        for i in range(len(self._levels), len(hier)):
            lvl = hier[i]
            g = lvl.graph
            arrays = sync_stats.pull(g.row_ptr, g.col_idx, g.node_w, g.edge_w, lvl.coarse_of,
                                     phase="checkpoint_write")
            self.pull_budget += len(_LEVEL_ARRAYS)
            entry = {key: np.asarray(a) for key, a in zip(_LEVEL_ARRAYS, arrays)}
            entry["meta"] = {
                "n": int(g.n), "m": int(g.m),
                "max_node_weight": g._max_node_weight,
                "total_node_weight": g._total_node_weight,
                "total_edge_weight": g._total_edge_weight,
            }
            self._levels.append(entry)

    def _write(self, stage: str, coarsener, partition, cur_k: int) -> None:
        import time

        from ..utils.rng import RandomState

        t0 = time.perf_counter()
        num_levels = coarsener.num_levels
        pos = RandomState.chain_position()
        meta = {
            "version": _VERSION,
            "stage": stage,
            "num_levels": int(num_levels),
            "cur_k": int(cur_k),
            "boundary": int(self.boundary),
            "contractions": int(coarsener.contractions),
            "rng": {
                "seed": int(pos["seed"]),
                "host": pos["host"],
                "devices": [dev for dev, _ in pos["gens"]],
                "phase_draws": RandomState.phase_draws(),
            },
            "fingerprint": self.fingerprint,
            "levels": [lv["meta"] for lv in self._levels[:num_levels]],
            "census": dict(_census(),
                           checkpoint_write_pulls=sync_stats.phase_count("checkpoint_write"),
                           checkpoint_write_entitled=self.pull_budget),
        }
        arrays = {f"rng_gen{i}": state for i, (_, state) in enumerate(pos["gens"])}
        for i, lv in enumerate(self._levels[:num_levels]):
            for key in _LEVEL_ARRAYS:
                arrays[f"l{i}_{key}"] = lv[key]
        if partition is not None:
            arrays["partition"] = partition
        final = os.path.join(self.dir, f"ckpt_deep_b{self.boundary:04d}.npz")
        tmp = final + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, meta=np.array(json.dumps(meta)), **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        if not self.keep_all and self._last_path and self._last_path != final:
            try:
                os.remove(self._last_path)
            except OSError:
                pass
        self._last_path = final
        write = dict(boundary=self.boundary, stage=stage, s=time.perf_counter() - t0,
                     bytes=os.path.getsize(final))
        self.writes.append(write)
        Logger.log(f"checkpoint: boundary {write['boundary']} ({stage}, {num_levels} levels) "
                   f"written in {write['s']:.6f} s, {write['bytes']} B: {final}")


def _census() -> dict:
    """The readback totals at the boundary, for the record (resume checks
    nothing against them); the writer adds its own pulls so far and their
    entitlement.  The JAX package adds its compile counts; the port has no
    compile census."""
    sync = sync_stats.snapshot()
    return {"host_sync_count": sync["count"], "host_sync_bytes": sync["bytes"],
            "implicit": sync["implicit"]}


# ---------------------------------------------------------------------------
# Load and restore
# ---------------------------------------------------------------------------


def latest(directory: str) -> Optional[str]:
    """Path of the highest-boundary checkpoint in ``directory``."""
    best: Optional[tuple] = None
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    for name in names:
        match = _FILE_RE.match(name)
        if match:
            key = (int(match.group(1)), name)
            if best is None or key > best:
                best = key
    return os.path.join(directory, best[1]) if best else None


def load(path: str) -> CheckpointState:
    """Load a checkpoint file, or the latest one in a directory."""
    if os.path.isdir(path):
        resolved = latest(path)
        if resolved is None:
            raise FileNotFoundError(f"no checkpoint files in {path!r}")
        path = resolved
    with np.load(path) as npz:
        meta = json.loads(str(npz["meta"][()]))
        if meta.get("version") != _VERSION:
            raise CheckpointMismatchError(f"checkpoint version {meta.get('version')} != {_VERSION}")
        levels = []
        for i, lv_meta in enumerate(meta["levels"]):
            entry = {key: npz[f"l{i}_{key}"] for key in _LEVEL_ARRAYS}
            entry["meta"] = lv_meta
            levels.append(entry)
        rng = meta["rng"]
        position = {"seed": int(rng["seed"]), "host": rng["host"],
                    "gens": [(dev, npz[f"rng_gen{i}"]) for i, dev in enumerate(rng["devices"])]}
        partition = np.asarray(npz["partition"]) if "partition" in npz.files else None
    return CheckpointState(
        stage=meta["stage"], num_levels=int(meta["num_levels"]), cur_k=int(meta["cur_k"]),
        partition=partition, levels=levels, rng=position,
        contractions=int(meta["contractions"]), boundary=int(meta["boundary"]),
        fingerprint=meta["fingerprint"], meta=meta, path=path,
    )


def to_device(arr: np.ndarray, device):
    """A host array on ``device`` without a synchronizing copy: on the card
    through pinned memory, non-blocking."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(arr))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def restore_into(coarsener, state: CheckpointState, device) -> None:
    """Rebuild the coarsener's level stack on ``device`` from a loaded
    checkpoint: host-to-device copies only, no readback (asserted by the
    deep scheme under ``checkpoint_restore``).  Each level's cached
    scalars, host row_ptr and edge sources are seeded, so no later
    property access reads the level back."""
    from ..coarsening.cluster_coarsener import CoarseLevel
    from ..graph.csr import CSRGraph

    for lv in state.levels[: state.num_levels]:
        meta = lv["meta"]
        rp = np.asarray(lv["rp"], dtype=np.int64)
        edge_u = np.repeat(np.arange(rp.size - 1, dtype=np.int32), np.diff(rp))
        g = CSRGraph(to_device(lv["rp"], device), to_device(lv["ci"], device),
                     to_device(lv["nw"], device), to_device(lv["ew"], device),
                     edge_u=to_device(edge_u, device), device=device)
        g._host_row_ptr = rp
        g._max_node_weight = meta.get("max_node_weight")
        g._total_node_weight = meta.get("total_node_weight")
        g._total_edge_weight = meta.get("total_edge_weight")
        coarsener.hierarchy.append(CoarseLevel(g, to_device(lv["co"], device)))
    coarsener.contractions = int(state.contractions)


# ---------------------------------------------------------------------------
# Pipeline entry
# ---------------------------------------------------------------------------

_warned_envelope = [False]


def writer_for(ctx, graph, communities=None, compressed=None,
               resume: Optional[CheckpointState] = None) -> Optional[CheckpointWriter]:
    """The armed writer of one deep run, or None when disarmed or outside
    the envelope (a dense input, no v-cycle communities, no compressed
    source; armed outside it, warned once)."""
    directory = resolve_dir(ctx.resilience)
    if directory is None:
        return None
    if graph is None or communities is not None or compressed is not None:
        if not _warned_envelope[0]:
            _warned_envelope[0] = True
            warnings.warn(
                "kaminpar_tpu_torch checkpoint: armed outside the envelope (dense DEEP "
                "input, no v-cycle communities, no compressed source); this run "
                "proceeds un-checkpointed.", RuntimeWarning)
        return None
    writer = CheckpointWriter(directory, every=_every(ctx.resilience),
                              keep_all=bool(getattr(ctx.resilience, "checkpoint_keep_all", False)),
                              fp=fingerprint(ctx, graph))
    if resume is not None:
        writer.seed_from_state(resume)
    return writer
