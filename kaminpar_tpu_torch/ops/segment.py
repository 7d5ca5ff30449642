"""Sort-reduce and reduce-by-key primitives (counterpart of
``kaminpar_tpu/ops/segment.py``).

The segment reductions follow ``jax.ops.segment_*``: a segment that
receives no value holds the reduction's identity (0, the dtype's lowest or
highest value, or -inf/+inf).
"""

from __future__ import annotations

import torch


def run_starts(sorted_key: torch.Tensor) -> torch.Tensor:
    """Mask of the first slot of every run of equal keys."""
    if sorted_key.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=sorted_key.device)
    first = torch.ones_like(sorted_key, dtype=torch.bool)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    return first


def run_starts2(sorted_a: torch.Tensor, sorted_b: torch.Tensor) -> torch.Tensor:
    """run_starts for a composite (a, b) key."""
    if sorted_a.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=sorted_a.device)
    first = torch.ones_like(sorted_a, dtype=torch.bool)
    first[1:] = (sorted_a[1:] != sorted_a[:-1]) | (sorted_b[1:] != sorted_b[:-1])
    return first


def run_ids(first_mask: torch.Tensor) -> torch.Tensor:
    """Dense run index per slot: [0, #runs)."""
    return torch.cumsum(first_mask.to(torch.int32), 0, dtype=torch.int32) - 1


def _identity(dtype, lowest: bool):
    if dtype.is_floating_point:
        return float("-inf") if lowest else float("inf")
    info = torch.iinfo(dtype)
    return info.min if lowest else info.max


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    out = torch.zeros(num, dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg, values)


def segment_max(values: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    out = torch.full((num,), _identity(values.dtype, True), dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, seg.long(), values, "amax", include_self=True)


def segment_min(values: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    out = torch.full((num,), _identity(values.dtype, False), dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, seg.long(), values, "amin", include_self=True)


def first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum (``jnp.argmin`` semantics)."""
    idx = torch.arange(x.shape[0], device=x.device)
    return torch.where(x == x.min(), idx, x.shape[0]).min()
