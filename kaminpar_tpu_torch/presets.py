"""Named presets (as in ``kaminpar_tpu/presets.py``): of the deep scheme
``default``, ``fast``, ``eco``, ``eco-devext``, ``strong``, ``jet``,
``4xjet``, ``noref``, ``serve``, the largek and terapart variants and the
rename aliases ``fm``, ``flow`` and ``esa21-*``; of the other schemes
``kway`` (alias ``mtkahypar-kway``), ``linear-time-kway``, ``vcycle`` and
``restricted-vcycle``."""

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


def create_eco_context() -> Context:
    """Overload balancer, LP, k-way FM, overload balancer (and the underload
    balancer)."""
    ctx = create_default_context()
    ctx.preset_name = "eco"
    ctx.refinement.algorithms = (
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.LP,
        RefinementAlgorithm.KWAY_FM,
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.UNDERLOAD_BALANCER,
    )
    return ctx


def create_eco_devext_context() -> Context:
    """eco with device extension, the best of 2 attempts."""
    ctx = create_eco_context()
    ctx.preset_name = "eco-devext"
    ctx.initial_partitioning.device_extension = True
    ctx.initial_partitioning.device_extension_reps = 2
    return ctx


def create_strong_context() -> Context:
    """The eco chain with JET before FM: JET's temperature-admitted
    negative moves open new basins, and FM, the last quality refiner, only
    descends."""
    ctx = create_eco_context()
    ctx.preset_name = "strong"
    ctx.refinement.algorithms = (
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.LP,
        RefinementAlgorithm.JET,
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.KWAY_FM,
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.UNDERLOAD_BALANCER,
    )
    return ctx


def create_jet_context(num_rounds: int = 1) -> Context:
    """JET as the only refiner (it balances internally), num_rounds chained
    invocations ("4xjet": 4)."""
    ctx = create_default_context()
    ctx.preset_name = "jet" if num_rounds == 1 else f"{num_rounds}xjet"
    ctx.refinement.algorithms = (
        RefinementAlgorithm.JET,
        RefinementAlgorithm.UNDERLOAD_BALANCER,
    )
    ctx.refinement.jet.num_rounds = num_rounds
    return ctx


def create_noref_context() -> Context:
    """No refinement at all."""
    ctx = create_default_context()
    ctx.preset_name = "noref"
    ctx.refinement.algorithms = ()
    return ctx


def create_largek_eco_context() -> Context:
    """largek with the eco chain."""
    ctx = _apply_largek_delta(create_eco_context())
    ctx.preset_name = "largek-eco"
    return ctx


def create_largek_strong_context() -> Context:
    """largek with the strong chain."""
    ctx = _apply_largek_delta(create_strong_context())
    ctx.preset_name = "largek-strong"
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


def create_terapart_eco_context() -> Context:
    """eco over a compressed input graph, as terapart; JET and FM run on the
    finest level's decoded CSR."""
    ctx = create_eco_context()
    ctx.preset_name = "terapart-eco"
    ctx.compression.enabled = True
    ctx.compression.device_decode = "auto"
    return ctx


def create_terapart_largek_context() -> Context:
    """largek over a compressed input graph, as terapart."""
    ctx = _apply_largek_delta(create_default_context())
    ctx.preset_name = "terapart-largek"
    ctx.compression.enabled = True
    ctx.compression.device_decode = "auto"
    return ctx


def create_kway_context() -> Context:
    """Single-shot k-way multilevel: coarsen to contraction_limit x k nodes,
    partition into k blocks at once, refine at k on every level."""
    ctx = create_default_context()
    ctx.preset_name = "kway"
    ctx.mode = PartitioningMode.KWAY
    return ctx


def create_linear_time_kway_context() -> Context:
    """k-way with 2 LP sweeps a level and threshold sparsification of the
    coarse graphs, for worst-case linear total work."""
    ctx = create_kway_context()
    ctx.preset_name = "linear-time-kway"
    ctx.coarsening.lp.num_iterations = 2
    ctx.coarsening.sparsification.enabled = True
    ctx.refinement.algorithms = (
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.LP,
    )
    return ctx


def create_vcycle_context(restricted: bool = False) -> Context:
    """Deep multilevel through the intermediate k of ``ctx.vcycles``: each
    cycle's partition constrains the next one's coarsening (and, when
    restricted, its refinement)."""
    ctx = create_default_context()
    ctx.preset_name = "restricted-vcycle" if restricted else "vcycle"
    ctx.mode = PartitioningMode.VCYCLE
    ctx.restrict_vcycle_refinement = restricted
    return ctx


def create_serve_context() -> Context:
    """The serve engine's preset (``serve/``): the fast preset's budgets,
    which bound each request's latency; its warmup and batch knobs are in
    ``ctx.serve``.  On a CUDA device every bisection runs on the device
    pool (``ip_backend`` "auto")."""
    ctx = _apply_fast_delta(create_default_context())
    ctx.preset_name = "serve"
    ctx.serve.max_batch = 8
    ctx.serve.queue_bound = 64
    ctx.initial_partitioning.ip_backend = "auto"
    return ctx


_PRESETS = {
    "default": create_default_context,
    "fast": create_fast_context,
    "eco": create_eco_context,
    "eco-devext": create_eco_devext_context,
    "fm": create_eco_context,  # rename alias
    "strong": create_strong_context,
    "flow": create_strong_context,  # rename alias
    "jet": create_jet_context,
    "4xjet": lambda: create_jet_context(4),
    "noref": create_noref_context,
    "largek": create_largek_context,
    "largek-fast": create_largek_fast_context,
    "largek-eco": create_largek_eco_context,
    "largek-strong": create_largek_strong_context,
    "terapart": create_terapart_context,
    "terapart-eco": create_terapart_eco_context,
    "terapart-largek": create_terapart_largek_context,
    # the ESA'21 deep multilevel configurations, rename aliases
    "esa21-smallk": create_default_context,
    "esa21-largek": create_largek_context,
    "esa21-largek-fast": create_largek_fast_context,
    "esa21-strong": create_strong_context,
    "kway": create_kway_context,
    "mtkahypar-kway": create_kway_context,  # rename alias
    "linear-time-kway": create_linear_time_kway_context,
    "vcycle": create_vcycle_context,
    "restricted-vcycle": lambda: create_vcycle_context(True),
    "serve": create_serve_context,
}


def get_preset_names() -> list:
    return sorted(_PRESETS)


def create_context_by_preset_name(name: str) -> Context:
    try:
        ctx = _PRESETS[name]()
    except KeyError:
        raise ValueError(
            f"unknown preset '{name}'; available: {sorted(_PRESETS)}"
        ) from None
    return copy.deepcopy(ctx)

