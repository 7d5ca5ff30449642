"""Named presets: ``default``, ``fast`` and ``terapart`` (as in
``kaminpar_tpu/presets.py``)."""

from __future__ import annotations

import copy

from .context import Context, PartitioningMode, RefinementAlgorithm


def create_default_context() -> Context:
    """LP coarsening, deep scheme, overload balancer -> LP -> underload
    balancer (the latter is a no-op without minimum block weights)."""
    ctx = Context(preset_name="default")
    ctx.mode = PartitioningMode.DEEP
    ctx.refinement.algorithms = (
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.LP,
        RefinementAlgorithm.UNDERLOAD_BALANCER,
    )
    return ctx


def create_fast_context() -> Context:
    """Default with the fast preset's reduced iteration budgets."""
    ctx = create_default_context()
    ctx.preset_name = "fast"
    ctx.coarsening.lp.num_iterations = 1
    ctx.refinement.lp.num_iterations = 2
    ctx.initial_partitioning.min_num_repetitions = 1
    ctx.initial_partitioning.max_num_repetitions = 2
    return ctx


def create_terapart_context() -> Context:
    """The memory tier: the default pipeline over a compressed input graph,
    the finest level running off the device-resident compressed stream."""
    ctx = create_default_context()
    ctx.preset_name = "terapart"
    ctx.compression.enabled = True
    ctx.compression.device_decode = "auto"
    return ctx


_PRESETS = {
    "default": create_default_context,
    "fast": create_fast_context,
    "terapart": create_terapart_context,
}


def create_context_by_preset_name(name: str) -> Context:
    try:
        ctx = _PRESETS[name]()
    except KeyError:
        raise ValueError(
            f"unknown preset '{name}'; available: {sorted(_PRESETS)}"
        ) from None
    return copy.deepcopy(ctx)

