"""Deterministic fault injection (counterpart of
``kaminpar_tpu/resilience/faults.py``).

Named injection points sit on the port's main path at the JAX package's
sites, under its site strings, so that one plan arms both packages:

=============  ==========================================================
``compile``    a fresh padded shape bucket (``graph/csr.py`` ``padded()``)
``execute``    the LP kernel dispatch (``coarsening/lp_clusterer.py``,
               site ``lp_pallas``), the device bipartition pool
               (``initial/bipartitioner.py``, ``ip_device``) and the
               device-decode gate (``graph/device_compressed.py``,
               ``device_decode``)
``readback``   every counted blocking readback (``utils/sync_stats.pull``)
``queue-admit``, ``warmup``
               the serve tier's points, parsed and counted but not yet
               reached (the port has no serve tier)
``preempt``    the deep pipeline's level boundaries: a firing spec sends
               the process SIGTERM instead of raising (the boundary's
               checkpoint is already on disk when it lands)
=============  ==========================================================

A plan is a comma-separated list of specs ``point[@site]:error[:key=value
...]`` with keys ``n`` (most injections, 0 = unlimited, default 1),
``after`` (matching hits to let pass first), ``p`` (probability, decided
by a hash of (plan seed, spec index, hit index): no random stream is
drawn, and a run replays under the same plan and seed) and ``delay``
(seconds to sleep before raising).  ``error`` is a failure-class name of
``resilience/errors.py``.

A plan is armed with :func:`injected_faults`, or from the environment (``KPTPU_FAULTS``, ``KPTPU_FAULTS_SEED``), read at the first
:func:`maybe_inject`; the environment reaches child processes.  Disarmed,
:func:`maybe_inject` is one list read.

**An injected fault raises its typed error and nothing demotes**: the
port has no fallback from a kernel, the device pool or device decode to a
plain version, so the run stops with the error.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .errors import FAILURE_CLASSES, ResilienceError

INJECTION_POINTS = (
    "compile", "execute", "readback", "queue-admit", "warmup", "preempt",
)


@dataclass
class FaultSpec:
    """One armed fault: where, what, when."""

    point: str
    error: str = "execute-fault"
    site: str = ""        # substring filter on the call site ("" = any)
    count: int = 1        # max injections; 0 = unlimited
    after: int = 0        # matching hits to pass through first
    p: float = 1.0        # seed-keyed injection probability
    delay_s: float = 0.0  # sleep before raising (simulated hang)
    # Mutable counters (per armed plan):
    hits: int = field(default=0, compare=False)
    injected: int = field(default=0, compare=False)

    def validate(self) -> "FaultSpec":
        if self.point not in INJECTION_POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r} "
                f"(expected one of {INJECTION_POINTS})"
            )
        if self.error not in FAILURE_CLASSES:
            raise ValueError(
                f"unknown failure class {self.error!r} "
                f"(expected one of {tuple(FAILURE_CLASSES)})"
            )
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p={self.p} outside [0, 1]")
        if self.count < 0:
            raise ValueError(f"n={self.count} must be >= 0")
        if self.after < 0:
            raise ValueError(f"after={self.after} must be >= 0")
        if self.delay_s < 0:
            raise ValueError(f"delay={self.delay_s} must be >= 0")
        return self


@dataclass
class FaultPlan:
    """A parsed, seed-keyed set of :class:`FaultSpec`."""

    specs: List[FaultSpec]
    seed: int = 0
    source: str = ""

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Parse a plan string; a malformed plan raises ``ValueError``
        naming the offending spec when it is armed, never arms in part.
        Rejected: unknown
        point/error/key names, non-numeric or negative ``n=``/``after=``/
        ``p=``/``delay=`` values, and duplicate (point, site, error)
        specs (the second copy would be unreachable: the first matching
        spec wins every hit)."""
        specs: List[FaultSpec] = []
        seen: set = set()
        for raw in text.split(","):
            raw = raw.strip()
            if not raw:
                continue
            parts = raw.split(":")
            point, _, site = parts[0].strip().partition("@")
            spec = FaultSpec(point=point.strip(), site=site.strip())
            if len(parts) > 1 and parts[1].strip():
                spec.error = parts[1].strip()
            for kv in parts[2:]:
                key, _, val = kv.partition("=")
                key = key.strip()
                try:
                    if key == "n":
                        spec.count = int(val)
                    elif key == "after":
                        spec.after = int(val)
                    elif key == "p":
                        spec.p = float(val)
                    elif key == "delay":
                        spec.delay_s = float(val)
                    else:
                        raise ValueError(
                            f"unknown fault-spec key {key!r} in {raw!r}"
                        )
                except ValueError as exc:
                    if "fault-spec key" in str(exc):
                        raise
                    raise ValueError(
                        f"malformed {key}= value {val!r} in fault spec "
                        f"{raw!r}"
                    ) from None
            try:
                spec.validate()
            except ValueError as exc:
                raise ValueError(f"{exc} (in fault spec {raw!r})") from None
            # Duplicate = FULLY identical spec (point, site, error AND
            # all firing parameters).  Same-(point, site, error) specs
            # with different n=/after=/p= are legal STAGED plans — the
            # matcher falls through exhausted or after-gated specs, so
            # "fire at hit 1 and again at hit 11" is two specs on
            # purpose; only an exact copy is redundant by construction.
            ident = (spec.point, spec.site, spec.error, spec.count,
                     spec.after, spec.p, spec.delay_s)
            if ident in seen:
                raise ValueError(
                    f"duplicate fault spec {raw!r} — an identical copy "
                    "is already in the plan and could never add a firing"
                )
            seen.add(ident)
            specs.append(spec)
        return cls(specs=specs, seed=int(seed), source=text)


_lock = threading.Lock()
_armed: List[Optional[FaultPlan]] = [None]
_env_checked = [False]
#: process-lifetime census per injection point: [hits, injected]
_point_census: Dict[str, List[int]] = {}


def _coin(seed: int, spec_idx: int, hit: int, p: float) -> bool:
    """Seed-keyed coin: the decision for hit ``hit`` of spec ``spec_idx``
    is a pure function of (seed, spec_idx, hit); no random stream is
    drawn.  The JAX package's hash, so both packages decide alike."""
    if p >= 1.0:
        return True
    if p <= 0.0:
        return False
    digest = hashlib.blake2b(
        f"{seed}:{spec_idx}:{hit}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") / float(1 << 64) < p


def arm(plan: FaultPlan) -> None:
    """Arm a plan process-wide (replacing any armed plan)."""
    with _lock:
        _armed[0] = plan
        _env_checked[0] = True  # an explicit plan outranks the environment


def disarm() -> None:
    with _lock:
        _armed[0] = None
        _env_checked[0] = True


def reset() -> None:
    """Disarm and zero the census (tests); re-enables env discovery."""
    with _lock:
        _armed[0] = None
        _env_checked[0] = False
        _point_census.clear()


def plan_from_env() -> Optional[FaultPlan]:
    text = os.environ.get("KPTPU_FAULTS", "")
    if not text:
        return None
    seed = int(os.environ.get("KPTPU_FAULTS_SEED", "0") or 0)
    plan = FaultPlan.parse(text, seed=seed)
    plan.source = f"env:{text}"
    return plan


def active_plan() -> Optional[FaultPlan]:
    with _lock:
        if not _env_checked[0]:
            _env_checked[0] = True
            try:
                _armed[0] = plan_from_env()
            except ValueError:
                import warnings

                warnings.warn(
                    f"kaminpar_tpu_torch resilience: unparseable KPTPU_FAULTS="
                    f"{os.environ.get('KPTPU_FAULTS')!r} ignored",
                    RuntimeWarning,
                )
                _armed[0] = None
        return _armed[0]


@contextmanager
def injected_faults(plan):
    """Arm ``plan`` (a :class:`FaultPlan` or a spec string) for the block;
    the previous arming is restored on exit."""
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    with _lock:
        prev, prev_env = _armed[0], _env_checked[0]
        _armed[0] = plan
        _env_checked[0] = True
    try:
        yield plan
    finally:
        with _lock:
            _armed[0], _env_checked[0] = prev, prev_env


def maybe_inject(point: str, site: str = "") -> None:
    """Raise the armed typed fault for ``point`` if the plan says so.

    Disarmed (the default), this is a single list read.  The raised error
    carries ``injected=True`` and the site string, and the per-point
    census (:func:`snapshot`) counts hits and injections.
    """
    if _armed[0] is None and _env_checked[0]:
        return
    plan = active_plan()
    if plan is None:
        return
    fire: Optional[FaultSpec] = None
    with _lock:
        row = _point_census.setdefault(point, [0, 0])
        row[0] += 1
        for idx, spec in enumerate(plan.specs):
            if spec.point != point:
                continue
            if spec.site and spec.site not in site:
                continue
            spec.hits += 1
            if spec.hits <= spec.after:
                continue
            if spec.count and spec.injected >= spec.count:
                continue
            if not _coin(plan.seed, idx, spec.hits, spec.p):
                continue
            spec.injected += 1
            row[1] += 1
            fire = spec
            break
    if fire is None:
        return
    if fire.delay_s > 0:
        time.sleep(fire.delay_s)
    if fire.point == "preempt":
        # Preemption is a process death, not an exception: SIGTERM
        # ourselves (the default handler terminates), as a preempted
        # worker receives it.  The caller sees the process die and resumes
        # from its checkpoint (resilience/checkpoint.py); the spec's error
        # class is unused.
        import signal

        os.kill(os.getpid(), signal.SIGTERM)
        # Signal delivery happens on the main thread between bytecodes;
        # from a worker thread, give it a beat rather than racing on.
        time.sleep(5.0)
        return
    err_cls = FAILURE_CLASSES[fire.error]
    raise _construct(err_cls, fire, point, site)


def _construct(err_cls, spec: FaultSpec, point: str, site: str) -> ResilienceError:
    message = (
        f"injected {spec.error} at {point}"
        + (f" (site {site})" if site else "")
        + f" [#{spec.injected}]"
    )
    from .errors import PoisonedCell

    if err_cls is PoisonedCell:
        err = PoisonedCell((), 0.0, site=site, injected=True)
    else:
        err = err_cls(message, site=site, injected=True)
    return err


def snapshot() -> dict:
    """{armed, source, seed, points: {point: {hits, injected}},
    specs: [...]}: the injection census."""
    with _lock:
        plan = _armed[0]
        out = {
            "armed": plan is not None,
            "source": plan.source if plan else "",
            "seed": plan.seed if plan else 0,
            "points": {
                pt: {"hits": row[0], "injected": row[1]}
                for pt, row in sorted(_point_census.items())
            },
            "specs": [
                {
                    "point": s.point, "site": s.site, "error": s.error,
                    "count": s.count, "after": s.after, "p": s.p,
                    "hits": s.hits, "injected": s.injected,
                }
                for s in (plan.specs if plan else [])
            ],
        }
    return out
