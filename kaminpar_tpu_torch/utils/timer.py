"""Hierarchical wall-clock timer tree (counterpart of
``kaminpar_tpu/utils/timer.py``).

Nested named scopes add their wall time into a tree, printed
human-readable (:meth:`Timer.render`) or as the machine-readable ``TIME
key=value`` line (:meth:`Timer.machine_readable`).  Work on the card runs
asynchronously, so a scope measures the host's time to queue it unless
sync mode is on (:func:`set_sync_mode`): then a ``sync=True`` scope waits
for the stream of the tensor it noted before it closes.

Every thread adds into its own subtree (the creating thread owns the
root); reports merge the subtrees by scope name.  While a trace recorder
is active every scope is also a span of the run trace, and a
``torch.autograd.profiler.record_function`` range, so that a
``torch.profiler`` capture shows the scope names.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import torch

from ..telemetry import phases as _phases
from ..telemetry import trace as _ttrace


class _TimerNode:
    __slots__ = ("name", "elapsed", "starts", "children")

    def __init__(self, name: str):
        self.name = name
        self.elapsed = 0.0
        self.starts = 0
        self.children: Dict[str, "_TimerNode"] = {}

    def child(self, name: str) -> "_TimerNode":
        node = self.children.get(name)
        if node is None:
            node = self.children[name] = _TimerNode(name)
        return node


def _merge(dst: _TimerNode, src: _TimerNode) -> None:
    dst.elapsed += src.elapsed
    dst.starts += src.starts
    # list(): a live thread may insert a child during the merge
    for name, child in list(src.children.items()):
        _merge(dst.child(name), child)


class Timer:
    """The global hierarchical timer."""

    _global: Optional["Timer"] = None

    def __init__(self, name: str = "root"):
        self._root = _TimerNode(name)
        self._tls = threading.local()
        self._tls.stack = [self._root]  # the creating thread's
        self._subtrees: List[_TimerNode] = []
        self._subtree_lock = threading.Lock()
        self._disabled = 0  # depth counter: disabled sections nest
        self._disabled_lock = threading.Lock()

    @classmethod
    def global_(cls) -> "Timer":
        if cls._global is None:
            cls._global = Timer()
        return cls._global

    @classmethod
    def reset_global(cls) -> None:
        cls._global = Timer()

    def enable(self) -> None:
        with self._disabled_lock:
            self._disabled = max(self._disabled - 1, 0)

    def disable(self) -> None:
        """Stop recording scopes, for the threaded extension jobs; nests as
        a depth counter."""
        with self._disabled_lock:
            self._disabled += 1

    def _stack(self) -> list:
        """This thread's scope stack; other threads than the creator root in
        a subtree of their own."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            root = _TimerNode(threading.current_thread().name or "thread")
            with self._subtree_lock:
                self._subtrees.append(root)
            stack = self._tls.stack = [root]
        return stack

    def current_path(self) -> tuple:
        """The names of this thread's open scopes, outermost first."""
        return tuple(node.name for node in self._stack()[1:])

    @contextmanager
    def scope(self, name: str):
        if self._disabled:
            yield
            return
        stack = self._stack()
        node = stack[-1].child(name)
        node.starts += 1
        stack.append(node)
        rec = _ttrace.active()
        armed = False
        if rec is not None:
            rec.begin(name)
            armed = rec.arm_profiler(name)
        start = time.perf_counter()
        try:
            ranged = (torch.autograd.profiler.record_function(name)
                      if rec is not None else nullcontext())
            with ranged:
                yield
        finally:
            node.elapsed += time.perf_counter() - start
            stack.pop()
            if rec is not None:
                if armed:
                    rec.disarm_profiler()
                rec.end(name)

    # -- reporting ---------------------------------------------------------

    def merged_root(self) -> _TimerNode:
        """One tree over every thread's subtree (per-name sums of elapsed and
        starts; other threads' top-level scopes merge as top-level
        phases)."""
        out = _TimerNode(self._root.name)
        _merge(out, self._root)
        with self._subtree_lock:
            subtrees = list(self._subtrees)
        for sub in subtrees:
            for child in list(sub.children.values()):
                _merge(out.child(child.name), child)
        return out

    def phase_seconds(self, *path: str) -> Optional[float]:
        """Merged seconds of the scope at ``path`` (e.g.
        ``phase_seconds("partitioning", "coarsening")``); None when it never
        ran."""
        node = self.merged_root()
        for name in path:
            node = node.children.get(name)
            if node is None:
                return None
        return node.elapsed

    def paths(self, max_depth: int = 99) -> Dict[str, dict]:
        """{"a.b": {"s": seconds, "starts": n}} for every scope down to
        ``max_depth`` (0: the top-level scopes)."""
        out: Dict[str, dict] = {}

        def walk(node, prefix, depth):
            for child in node.children.values():
                key = prefix + child.name
                out[key] = {"s": child.elapsed, "starts": child.starts}
                if depth < max_depth:
                    walk(child, key + ".", depth + 1)

        walk(self.merged_root(), "", 0)
        return out

    def _walk(self, node: _TimerNode, depth: int, max_depth: int, out: list):
        if depth > max_depth:
            return
        out.append((depth, node.name, node.elapsed, node.starts))
        for child in node.children.values():
            self._walk(child, depth + 1, max_depth, out)

    def render(self, max_depth: int = 4) -> str:
        rows: list = []
        for child in self.merged_root().children.values():
            self._walk(child, 0, max_depth, rows)
        return "\n".join(f"{'  ' * depth}`-- {name}: {elapsed:.3f} s ({starts} runs)"
                         for depth, name, elapsed, starts in rows)

    def machine_readable(self) -> str:
        """The ``TIME key=value`` line."""
        rows: list = []
        for child in self.merged_root().children.values():
            self._walk(child, 0, 99, rows)
        parts, stack = [], []
        for depth, name, elapsed, _ in rows:
            stack = stack[:depth] + [name]
            parts.append(f"{'.'.join(stack)}={elapsed:.6f}")
        return "TIME " + " ".join(parts)


class ScopeClock:
    """The seconds a call adds to scopes of the global timer tree: the
    scope ``scope`` opened below this thread's open scopes, and
    ``children`` under it ({key: path below ``scope``}), read when the
    clock is made and again by :meth:`seconds`.  Calls that run more than
    once at the same place of the tree (the cycles of a v-cycle) each get
    their own share."""

    def __init__(self, scope: str, children: Dict[str, tuple]):
        timer = Timer.global_()
        base = timer.current_path() + (scope,)
        self._timer = timer
        self._paths = {key: base + tuple(path) for key, path in children.items()}
        self._before = self._read()

    def _read(self) -> Dict[str, float]:
        return {key: self._timer.phase_seconds(*path) or 0.0
                for key, path in self._paths.items()}

    def seconds(self) -> Dict[str, float]:
        now = self._read()
        return {key: now[key] - self._before[key] for key in now}


class SyncSentinel:
    """Holder yielded by :func:`scoped_timer`: a scope that ends with work
    queued on the card notes a result tensor here, and in sync mode the
    scope waits for that tensor's stream before it records its time."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def note(self, x) -> None:
        self.value = x


_sync_mode = False


def set_sync_mode(on: bool) -> None:
    """Profiling mode: ``scoped_timer(..., sync=True)`` scopes wait for
    their noted tensor's stream before they close.  Off by default: the
    waits drain the queue the card works from (they wait, they do not read
    back, so the readback counts stay the same)."""
    global _sync_mode
    _sync_mode = bool(on)


def sync_mode() -> bool:
    """The active engine runtime's flag (``context.EngineRuntime``), else
    the process default set by :func:`set_sync_mode`."""
    from ..context import current_runtime

    rt = current_runtime()
    return rt.sync_timers if rt is not None else _sync_mode


def _wait_for(t) -> None:
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


@contextmanager
def scoped_timer(name: str, sync: bool = False):
    """A timer scope, a heap-profiler scope and a sync-accounting phase of
    the same name (a trace span too while a recorder is active); ``name``
    is checked against the phase registry.  ``sync=True`` yields a
    :class:`SyncSentinel`; in sync mode the scope waits for the noted
    tensor's stream before it records its time."""
    from . import sync_stats
    from .heap_profiler import HeapProfiler

    _phases.check(name)
    sentinel = SyncSentinel()
    with Timer.global_().scope(name):
        with HeapProfiler.scope(name):
            with sync_stats.scoped(name):
                try:
                    yield sentinel
                finally:
                    if sync and sync_mode() and sentinel.value is not None:
                        _wait_for(sentinel.value)
