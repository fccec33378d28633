"""Disparity-slab (dslab) sharding: WTA as one argmin-combine (port of
`stereomatch_tpu/parallel/dslab.py`).

The reference's disparity-slice parallelism (OMP slice loop
src/PatchMatchStereoGPU.cu:8733-8769, stream pairs :8584-8617) on a
sharded D axis: every volume op before the selection is slice-local, so
the only cross-shard step of the aggregation is the WTA, two MIN
reductions over the "dslab" axis and a SUM-selected parabola fit, plus a
one-slice exchange so the fit sees its d±1 neighbours across shards.

Semantics are `ops.select.wta_disparity`'s, bit for bit: ties go to the
smallest global d, the out-of-volume neighbour costs 0.0, the update is
taken where |update| < 1.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["wta_disparity_dslab"]


def wta_disparity_dslab(vol: torch.Tensor, min_disp: int, mesh: Mesh, axis: str = "dslab",
                        subpixel: bool = True) -> torch.Tensor:
    """WTA disparity from this rank's slab of a D-sharded cost volume.

    vol: (H, W, Ds), the contiguous d-slices [k Ds, (k + 1) Ds) of the
    rank at index k along `axis`. Returns the (H, W) float32 disparity,
    the same on every rank of the axis."""
    n, k = mesh.size(axis), mesh.index(axis)
    ds = vol.shape[-1]
    best = torch.argmin(vol, dim=-1)  # the first minimum within the slab
    m = vol.amin(-1)
    gbest = best + k * ds

    # the global minimum, then the smallest global d that reaches it
    gmin = mesh.all_reduce(m, axis, dist.ReduceOp.MIN)
    winner = m == gmin
    gd = mesh.all_reduce(torch.where(winner, gbest, torch.full_like(gbest, n * ds)), axis,
                         dist.ReduceOp.MIN)
    mask = winner & (gbest == gd)  # on exactly one rank: the d-ranges are disjoint
    disp = (gd + min_disp).float()
    if not subpixel:
        return disp

    # d±1 neighbour costs, one boundary slice from each slab neighbour
    # (zeros at the global ends: the reference's out-of-volume cost 0.0,
    # .cu:1722-1725)
    from_prev = mesh.shift(vol[..., -1], axis, +1)
    from_next = mesh.shift(vol[..., 0], axis, -1)
    b = best[..., None]
    pre = torch.where(best == 0, from_prev, vol.gather(-1, (b - 1).clamp(min=0))[..., 0])
    nxt = torch.where(best == ds - 1, from_next, vol.gather(-1, (b + 1).clamp(max=ds - 1))[..., 0])
    zero = vol.new_zeros(())
    pre_g, nxt_g = mesh.all_reduce(torch.stack([torch.where(mask, pre, zero),
                                                torch.where(mask, nxt, zero)]), axis).unbind(0)
    update = (nxt_g - pre_g) * 0.5 / (nxt_g - 2.0 * gmin + pre_g)
    return torch.where(torch.abs(update) < 1.0, disp - update, disp)
