"""Seeded random streams.

The JAX package threads ``jax.random`` keys; the port keeps one seeded
``torch.Generator`` per device and a numpy ``Generator`` for the host
bipartition pool, all derived from the run's seed.  The streams are not
those of threefry: parity tests feed both packages the same draws instead
(see ``ops/lp.LPDraws``).

State is thread-local, and :meth:`RandomState.scoped` runs a block under
its own seed without disturbing the caller's streams (the per-block
extension jobs of ``partitioning/deep.py`` need that).

The chain position (:meth:`RandomState.chain_position`) is what a
checkpoint records and :meth:`RandomState.restore` rebuilds: the seed, the
host generator's ``bit_generator.state`` and, for every device generator
created so far, in creation order, its device and ``get_state()`` bytes
(a CUDA Philox generator's state is its seed and offset).  The JAX
package's position is (seed, draws), since its key after N splits is a
function of both; the port's streams are stateful generators, so it
records their states instead.  A draw count per phase is kept for the
record.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import numpy as np
import torch


class RandomState:
    _tls = threading.local()

    @classmethod
    def _state(cls) -> dict:
        st = getattr(cls._tls, "state", None)
        if st is None:
            cls.reseed(0)
            st = cls._tls.state
        return st

    @classmethod
    def reseed(cls, seed: int) -> None:
        cls._tls.state = {
            "seed": int(seed),
            "gens": {},
            "host": np.random.default_rng(int(seed)),
            "phase_draws": {},
        }

    @classmethod
    def _count_draw(cls, st: dict) -> None:
        from . import sync_stats

        phase = sync_stats.active_phase()
        st["phase_draws"][phase] = st["phase_draws"].get(phase, 0) + 1

    @classmethod
    def chain_position(cls) -> dict:
        """The serializable position of this thread's streams: ``seed``,
        ``host`` (the host generator's ``bit_generator.state``) and
        ``gens``, a list of (device, ``get_state()`` uint8 array) in
        creation order.  :meth:`restore` of it reproduces every later
        draw."""
        st = cls._state()
        return {
            "seed": st["seed"],
            "host": st["host"].bit_generator.state,
            "gens": [(dev, gen.get_state().numpy()) for dev, gen in st["gens"].items()],
        }

    @classmethod
    def phase_draws(cls) -> dict:
        """{phase: draws} since the last reseed: host generators handed out
        and device generators fetched, by the phase they were drawn in."""
        return dict(cls._state()["phase_draws"])

    @classmethod
    def restore(cls, position: dict) -> None:
        """Rebuild the streams at ``position`` (:meth:`chain_position`):
        the device generators are created in the recorded order and set to
        their states, the host generator to its state."""
        cls.reseed(position["seed"])
        st = cls._tls.state
        for dev, state in position["gens"]:
            gen = torch.Generator(device=torch.device(dev))
            gen.set_state(torch.from_numpy(np.asarray(state, dtype=np.uint8).copy()))
            st["gens"][dev] = gen
        st["host"].bit_generator.state = position["host"]

    @classmethod
    def generator(cls, device) -> torch.Generator:
        """The run's generator on ``device``, created on first use and
        seeded by a draw from the run's host stream."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        st = cls._state()
        cls._count_draw(st)
        gen = st["gens"].get(str(device))
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(st["host"].integers(1 << 62)))
            st["gens"][str(device)] = gen
        return gen

    @classmethod
    def numpy_rng(cls) -> np.random.Generator:
        """A fresh host generator for the sequential initial partitioner,
        derived from the run's seed chain."""
        st = cls._state()
        cls._count_draw(st)
        return np.random.default_rng(int(st["host"].integers(1 << 62)))

    @classmethod
    @contextmanager
    def scoped(cls, seed: int):
        """Run a block under its own seed; the caller's streams resume
        unchanged afterwards."""
        saved = getattr(cls._tls, "state", None)
        cls.reseed(seed)
        try:
            yield
        finally:
            cls._tls.state = saved
