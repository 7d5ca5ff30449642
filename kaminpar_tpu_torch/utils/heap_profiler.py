"""Device and heap memory profiler (counterpart of
``kaminpar_tpu/utils/heap_profiler.py``).

Scoped sections record the memory in use at their entry and exit and the
peak at their exit, as a tree.  On a card the numbers are the caching
allocator's (``torch.cuda.memory_stats``: ``allocated_bytes.all.current``
and ``.peak``, the limit from ``torch.cuda.mem_get_info``); on the CPU they
are the process's resident set (``/proc/self/statm``, and ``resource`` for
the peak).  The peak is process-wide and monotone, so a scope records the
peak at its exit, not its own.  The profiler never resets the peak: a
caller that measures peaks of its own (``chip_smoke.py``) owns that.
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


def _rss_bytes() -> Dict[str, int]:
    """Current and peak resident-set bytes of this process (Linux)."""
    out: Dict[str, int] = {}
    try:
        with open("/proc/self/statm") as fh:
            out["rss_bytes"] = int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # noqa: BLE001
        pass
    try:
        import resource

        out["peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # noqa: BLE001
        pass
    return out


def _device_stats(limit: bool = True) -> Optional[dict]:
    """{bytes_in_use, peak_bytes_in_use} of the current card, and with
    ``limit`` its bytes_limit; None without an initialised CUDA context."""
    if not torch.cuda.is_initialized():
        return None
    try:
        stats = torch.cuda.memory_stats()
        out = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        }
        if limit:
            out["bytes_limit"] = int(torch.cuda.mem_get_info()[1])
    except Exception:  # noqa: BLE001 - accounting must never fail a run
        return None
    return out


def _scope_stats() -> Dict[str, int]:
    """The numbers a scope records: the card's, else the resident set's."""
    stats = _device_stats(limit=False)
    if stats is not None:
        return stats
    rss = _rss_bytes()
    return {"bytes_in_use": rss.get("rss_bytes", 0),
            "peak_bytes_in_use": rss.get("peak_rss_bytes", 0)}


@dataclass
class HeapScope:
    name: str
    bytes_at_entry: int = 0
    bytes_at_exit: int = 0
    # the process-wide peak at exit (a scope's own peak is not observable)
    global_peak_at_exit: int = 0
    children: List["HeapScope"] = field(default_factory=list)


class HeapProfiler:
    """Scoped profiler, one tree per process.  Every thread records into
    its own subtree: the thread that called :meth:`reset` owns the root,
    other threads get a root each in ``_subtrees``."""

    _root: Optional[HeapScope] = None
    _subtrees: List[HeapScope] = []
    _tls = threading.local()
    _root_owner: int = 0
    _lock = threading.Lock()
    enabled: bool = False

    @classmethod
    def reset(cls, enabled: bool = True) -> None:
        cls._root = HeapScope("root")
        cls._subtrees = []
        cls._root_owner = threading.get_ident()
        cls._tls = threading.local()
        cls._tls.stack = [cls._root]
        cls.enabled = enabled

    @classmethod
    def _stack(cls) -> List[HeapScope]:
        stack = getattr(cls._tls, "stack", None)
        if stack is None:
            if threading.get_ident() == cls._root_owner:
                stack = [cls._root]
            else:
                root = HeapScope(f"thread:{threading.current_thread().name or 'worker'}")
                with cls._lock:
                    cls._subtrees.append(root)
                stack = [root]
            cls._tls.stack = stack
        return stack

    @classmethod
    @contextlib.contextmanager
    def scope(cls, name: str):
        if not cls.enabled or cls._root is None:
            yield
            return
        stack = cls._stack()
        node = HeapScope(name, bytes_at_entry=_scope_stats()["bytes_in_use"])
        stack[-1].children.append(node)
        stack.append(node)
        try:
            yield
        finally:
            stats = _scope_stats()
            node.bytes_at_exit = stats["bytes_in_use"]
            node.global_peak_at_exit = stats["peak_bytes_in_use"]
            stack.pop()
            from ..telemetry import trace as _ttrace

            rec = _ttrace.active()
            if rec is not None:
                rec.counter("device_bytes", {"in_use": node.bytes_at_exit,
                                             "peak": node.global_peak_at_exit})

    @classmethod
    def report(cls) -> str:
        if cls._root is None:
            return "heap profiler: disabled"
        stats = _device_stats()
        if stats is None:
            rss = _rss_bytes()
            lines = ["heap profiler: no card; resident set rss_bytes=%d peak_rss_bytes=%d"
                     % (rss.get("rss_bytes", 0), rss.get("peak_rss_bytes", 0))]
        else:
            lines = ["heap profiler: bytes_in_use=%d peak_bytes_in_use=%d"
                     % (stats["bytes_in_use"], stats["peak_bytes_in_use"])]

        def walk(node: HeapScope, depth: int):
            for ch in list(node.children):
                lines.append(
                    "%s%s: entry=%d exit=%d (delta %+d, global peak %d)"
                    % ("  " * depth, ch.name, ch.bytes_at_entry, ch.bytes_at_exit,
                       ch.bytes_at_exit - ch.bytes_at_entry, ch.global_peak_at_exit)
                )
                walk(ch, depth + 1)

        walk(cls._root, 1)
        with cls._lock:
            subtrees = list(cls._subtrees)
        for sub in subtrees:
            lines.append(f"  {sub.name}:")
            walk(sub, 2)
        return "\n".join(lines)


def memory_summary() -> Dict[str, int]:
    """bytes_in_use, peak_bytes_in_use and bytes_limit of the card (empty
    without one)."""
    return dict(_device_stats() or {})


def live_array_bytes() -> int:
    """Bytes of the live tensors of this process: the card's allocated
    bytes, or without a card the storages of the CPU tensors the garbage
    collector tracks (each storage once)."""
    if torch.cuda.is_initialized():
        return int(torch.cuda.memory_allocated())
    seen, total = set(), 0
    for obj in gc.get_objects():
        try:
            if issubclass(type(obj), torch.Tensor) and obj.device.type == "cpu":
                storage = obj.untyped_storage()
                if storage.data_ptr() not in seen:
                    seen.add(storage.data_ptr())
                    total += storage.nbytes()
        except Exception:  # noqa: BLE001
            continue
    return total


def watermark_backend() -> str:
    """Where the watermark numbers come from: ``cuda_allocator`` (the
    card's caching allocator) or ``cpu_rss_proxy`` (no card: the resident
    set and the live CPU tensors, a host number, never a card's)."""
    return "cuda_allocator" if _device_stats() is not None else "cpu_rss_proxy"


def watermark_report() -> Dict[str, object]:
    """Bytes in use, the peak, the limit and the peak's share of it, with
    the ``backend`` they come from; without a card the resident set and
    the live CPU tensors' bytes instead."""
    out: Dict[str, object] = dict(memory_summary())
    backend = watermark_backend()
    out["backend"] = backend
    peak, limit = out.get("peak_bytes_in_use"), out.get("bytes_limit")
    if peak is not None and limit:
        out["peak_frac_of_limit"] = round(int(peak) / int(limit), 4)
    if backend == "cpu_rss_proxy":
        out.update(_rss_bytes())
        out["live_array_bytes"] = live_array_bytes()
    return out
