"""Named presets: ``default``, ``fast``, ``terapart``, ``largek``,
``largek-fast`` and ``terapart-largek`` (as in ``kaminpar_tpu/presets.py``)."""

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


def _apply_fast_delta(ctx: Context) -> Context:
    """The fast preset's reduced iteration budgets."""
    ctx.coarsening.lp.num_iterations = 1
    ctx.refinement.lp.num_iterations = 2
    ctx.initial_partitioning.min_num_repetitions = 1
    ctx.initial_partitioning.max_num_repetitions = 2
    return ctx


def _apply_largek_delta(ctx: Context) -> Context:
    """The largek presets' tuning for large k: a bigger contraction limit,
    and device extension (``partitioning/extension.py``)."""
    ctx.coarsening.contraction_limit = 640
    ctx.initial_partitioning.device_extension = True
    return ctx


def create_fast_context() -> Context:
    """Default with the fast preset's reduced iteration budgets."""
    ctx = _apply_fast_delta(create_default_context())
    ctx.preset_name = "fast"
    return ctx


def create_terapart_context() -> Context:
    """The memory tier: the default pipeline over a compressed input graph,
    the finest level running off the device-resident compressed stream."""
    ctx = create_default_context()
    ctx.preset_name = "terapart"
    ctx.compression.enabled = True
    ctx.compression.device_decode = "auto"
    return ctx


def create_largek_context() -> Context:
    """Default tuned for k > 1024."""
    ctx = _apply_largek_delta(create_default_context())
    ctx.preset_name = "largek"
    return ctx


def create_largek_fast_context() -> Context:
    """largek with the fast preset's budgets."""
    ctx = _apply_fast_delta(create_largek_context())
    ctx.preset_name = "largek-fast"
    return ctx


def create_terapart_largek_context() -> Context:
    """largek over a compressed input graph, as terapart."""
    ctx = _apply_largek_delta(create_default_context())
    ctx.preset_name = "terapart-largek"
    ctx.compression.enabled = True
    ctx.compression.device_decode = "auto"
    return ctx


_PRESETS = {
    "default": create_default_context,
    "fast": create_fast_context,
    "terapart": create_terapart_context,
    "largek": create_largek_context,
    "largek-fast": create_largek_fast_context,
    "terapart-largek": create_terapart_largek_context,
}


def create_context_by_preset_name(name: str) -> Context:
    try:
        ctx = _PRESETS[name]()
    except KeyError:
        raise ValueError(
            f"unknown preset '{name}'; available: {sorted(_PRESETS)}"
        ) from None
    return copy.deepcopy(ctx)

