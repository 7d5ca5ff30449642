"""Maximum allowed cluster weight during coarsening (counterpart of
``kaminpar_tpu/coarsening/max_cluster_weights.py``):
EPSILON_BLOCK_WEIGHT -> eps * W / clamp(n / C, 2, k);
BLOCK_WEIGHT -> (1 + eps) * W / k; scaled by the multiplier."""

from __future__ import annotations

from ..context import ClusterWeightLimit, CoarseningContext


def compute_max_cluster_weight(c_ctx: CoarseningContext, n: int,
                               total_node_weight: int, k: int, epsilon: float) -> int:
    limit = c_ctx.cluster_weight_limit
    if limit == ClusterWeightLimit.EPSILON_BLOCK_WEIGHT:
        divisor = min(max(n // max(c_ctx.contraction_limit, 1), 2), k)
        w = epsilon * total_node_weight / divisor
    elif limit == ClusterWeightLimit.BLOCK_WEIGHT:
        w = (1.0 + epsilon) * total_node_weight / k
    elif limit == ClusterWeightLimit.ONE:
        w = 1.0
    else:
        w = 0.0
    return max(int(w * c_ctx.cluster_weight_multiplier), 1)
