"""Wrappers of kernel K1, the SGBM path aggregation, and of its carry entry
K1c (csrc/sgbm_aggregate.cu).

K1 replaces the JAX package's Pallas kernels in
`stereomatch_tpu/ops/sgbm_pallas.py` (`aggregate_8path_pallas`: `_row_pass`
/ `_row_kernel`, `_col_pass` / `_col_kernel` and their chunked-carry
variants). K1c is the same launch seeded from and drained to an explicit
carry, the counterpart of `_row_chunk_call` / `_row_kernel_carry`: the
band-streamed SGBM (`ops/sgbm.py::sgbm_disparity_banded`) runs on it. Their
plain PyTorch twin is `ops/sgbm.py::aggregate_paths` (`aggregate_8path` for
K1's direction sets).
"""

from __future__ import annotations

import torch

from .sgbm import SGBM_DIRECTIONS, aggregate_8path, aggregate_paths

__all__ = ["aggregate_8path_cuda", "aggregate_paths_cuda"]


def _check_cost(cost: torch.Tensor, kernel: str) -> None:
    if not cost.is_cuda:
        raise ValueError(f"{kernel} takes CUDA (or CPU) tensors, got one on {cost.device}")
    if cost.ndim != 3:
        raise ValueError(f"cost must be (H, W, D), got shape {tuple(cost.shape)}")
    if cost.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cost must be float32 or bfloat16, got {cost.dtype}")
    d = cost.shape[2]
    if d > 256 or d % 16:
        raise ValueError(f"{kernel} takes D <= 256 with D % 16 == 0, got D={d}")
    if not cost.is_contiguous():
        raise ValueError("cost must be contiguous (slice with .contiguous() first)")
    if cost.data_ptr() % 16:
        raise ValueError("cost must start on a 16-byte boundary (copy it with .clone() first)")


def _check_directions(directions) -> tuple[list[int], list[int]]:
    dys, dxs = (list(v) for v in zip(*directions)) if directions else ([], [])
    if not 1 <= len(dys) <= 8 or any(
            dy not in (-1, 0, 1) or dx not in (-1, 0, 1) or (dy, dx) == (0, 0)
            for dy, dx in zip(dys, dxs)):
        raise ValueError(f"1 to 8 directions (dy, dx) in {{-1, 0, 1}}^2 but (0, 0), got "
                         f"{directions}")
    return dys, dxs


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
    if num_paths not in SGBM_DIRECTIONS:
        raise ValueError(f"num_paths must be 4, 5 or 8, got {num_paths}")
    _check_cost(cost, "K1")
    s = torch.zeros(cost.shape, dtype=torch.float32, device=cost.device)
    if s.numel() == 0:
        return s
    from .._build import load_kernels

    dys, dxs = zip(*SGBM_DIRECTIONS[num_paths])
    none = s.new_empty(0)
    load_kernels().sgbm_aggregate(cost, s, list(dys), list(dxs), float(p1), float(p2), none,
                                  none)
    aggregate_8path_cuda.launches += 1
    return s


aggregate_8path_cuda.launches = 0


def aggregate_paths_cuda(
    cost: torch.Tensor,
    p1: float,
    p2: float,
    directions,
    carry_in: torch.Tensor | None = None,
    carry_out: torch.Tensor | None = None,
    with_s: bool = True,
) -> torch.Tensor | None:
    """K1c: S = sum over `directions` ((dy, dx) pairs) of Lr, float32, with
    the DP of each vertical or diagonal direction seeded from `carry_in`
    and drained to `carry_out` (the twin `aggregate_paths` says how). The
    carries are (c, W, D) float32 contiguous, c the number of directions
    with dy != 0, on cost's device, and do not overlap; with_s=False skips
    S and returns None. A CUDA tensor launches K1c once for all
    directions (raising on anything it does not take); a CPU tensor runs
    the twin. `aggregate_paths_cuda.launches` counts kernel launches.

    The carried state is float32 whatever the cost's dtype (the JAX
    package's band carry has the cost's dtype: with a bf16 cost they
    differ as K1 and the JAX scan do). S agrees with the twin as K1's does:
    bit for bit on integer-valued costs, else to float32 reassociation of
    the sum over directions; the carries bit for bit (no sum)."""
    if cost.device.type == "cpu":
        return aggregate_paths(cost, p1, p2, directions, carry_in, carry_out, with_s)
    _check_cost(cost, "K1c")
    dys, dxs = _check_directions(directions)
    carried = sum(dy != 0 for dy in dys)
    h, w, d = cost.shape
    for name, t in (("carry_in", carry_in), ("carry_out", carry_out)):
        if t is None:
            continue
        if t.device != cost.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be float32, contiguous, on {cost.device}")
        if tuple(t.shape) != (carried, w, d):
            raise ValueError(f"{name} must be ({carried}, {w}, {d}), got {tuple(t.shape)}")
    if carry_in is not None and carry_out is not None and (
            carry_in.data_ptr() < carry_out.data_ptr() + 4 * carry_out.numel()
            and carry_out.data_ptr() < carry_in.data_ptr() + 4 * carry_in.numel()):
        raise ValueError("carry_in and carry_out must not overlap")
    s = torch.zeros(cost.shape, dtype=torch.float32, device=cost.device) if with_s else None
    if h == 0 or w == 0:  # nothing to launch; with no row the state passes through
        if carry_out is not None:
            carry_out.copy_(carry_in) if carry_in is not None else carry_out.zero_()
        return s
    from .._build import load_kernels

    none = cost.new_empty(0, dtype=torch.float32)
    load_kernels().sgbm_aggregate(cost, none if s is None else s, dys, dxs, float(p1), float(p2),
                                  none if carry_in is None else carry_in,
                                  none if carry_out is None else carry_out)
    aggregate_paths_cuda.launches += 1
    return s


aggregate_paths_cuda.launches = 0
