"""Seeded random streams.

The JAX package threads ``jax.random`` keys; the port keeps one seeded
``torch.Generator`` per device and a numpy ``Generator`` for the host
bipartition pool, all derived from the run's seed.  The streams are not
those of threefry: parity tests feed both packages the same draws instead
(see ``ops/lp.LPDraws``).

State is thread-local, and :meth:`RandomState.scoped` runs a block under
its own seed without disturbing the caller's streams (the per-block
extension jobs of ``partitioning/deep.py`` need that).
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
            "gens": {},
            "host": np.random.default_rng(int(seed)),
        }

    @classmethod
    def generator(cls, device) -> torch.Generator:
        """The run's generator on ``device``, created on first use and
        seeded by a draw from the run's host stream."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        st = cls._state()
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
        return np.random.default_rng(int(cls._state()["host"].integers(1 << 62)))

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
