"""Wrapper of kernel K1, the SGBM path aggregation (csrc/sgbm_aggregate.cu).

K1 replaces the JAX package's Pallas kernels in
`stereomatch_tpu/ops/sgbm_pallas.py` (`aggregate_8path_pallas`: `_row_pass`
/ `_row_kernel`, `_col_pass` / `_col_kernel` and their chunked-carry
variants). Its plain PyTorch twin is `ops/sgbm.py::aggregate_8path`.
"""

from __future__ import annotations

import torch

from .sgbm import SGBM_DIRECTIONS, aggregate_8path

__all__ = ["aggregate_8path_cuda"]


def aggregate_8path_cuda(
    cost: torch.Tensor, p1: float, p2: float, num_paths: int = 8
) -> torch.Tensor:
    """S = sum over `num_paths` (8, 5 or 4) directions of Lr, float32.

    cost: (H, W, D) float32 or bfloat16, contiguous, D <= 256 and
    D % 16 == 0. A CUDA tensor launches K1 once for all directions (raising
    on anything the kernel does not take); a CPU tensor runs the twin.
    `aggregate_8path_cuda.launches` counts kernel launches.

    K1 adds each direction's Lr into S with atomic reductions, which land
    in any order, while the twin sums the directions one after another.
    Each Lr is the same, so S equals the twin's bit for bit when every
    partial sum is exact in float32: integer-valued costs, P1 and P2 with
    S below 2^24, as `sgbm_cost_volume` gives (its floors and block sums
    are integers, and bfloat16 keeps integers integral). Otherwise the two
    differ by float32 reassociation of the sum over directions."""
    if cost.device.type == "cpu":
        return aggregate_8path(cost, p1, p2, num_paths)
    if not cost.is_cuda:
        raise ValueError(f"K1 takes CUDA (or CPU) tensors, got one on {cost.device}")
    if num_paths not in SGBM_DIRECTIONS:
        raise ValueError(f"num_paths must be 4, 5 or 8, got {num_paths}")
    if cost.ndim != 3:
        raise ValueError(f"cost must be (H, W, D), got shape {tuple(cost.shape)}")
    if cost.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cost must be float32 or bfloat16, got {cost.dtype}")
    d = cost.shape[2]
    if d > 256 or d % 16:
        raise ValueError(f"K1 takes D <= 256 with D % 16 == 0, got D={d}")
    if not cost.is_contiguous():
        raise ValueError("cost must be contiguous (slice with .contiguous() first)")
    if cost.data_ptr() % 16:
        raise ValueError("cost must start on a 16-byte boundary (copy it with .clone() first)")
    s = torch.zeros(cost.shape, dtype=torch.float32, device=cost.device)
    if s.numel() == 0:
        return s
    from .._build import load_kernels

    dys, dxs = zip(*SGBM_DIRECTIONS[num_paths])
    load_kernels().sgbm_aggregate(cost, s, list(dys), list(dxs), float(p1), float(p2))
    aggregate_8path_cuda.launches += 1
    return s


aggregate_8path_cuda.launches = 0
