"""Band-pipelined SGBM: the DP carries handed from rank to rank (port of
`stereomatch_tpu/parallel/sgbm_pipeline.py`).

SGBM's vertical and diagonal paths couple every row to every other, so one
frame split over ranks serializes. The answer (SURVEY.md §5: scans with
carry exchange between tile neighbours) is a systolic pipeline over a
batch of frames: the rows are split into one band a rank; a frame's up
sweep flows from rank n-1 to 0 and its down sweep from 0 to n-1, one band
a macro-step, with the (ndir, W', D) carry sent to the neighbour after
each. A rank works on frame f + 1 while its neighbour takes frame f, so
with B frames in flight a sweep keeps B / (B + n - 1) of the ranks busy.

Each step is one launch of K1c (`ops.sgbm_cuda.aggregate_paths_cuda`, its
twin on the CPU), the call `ops.sgbm.sgbm_disparity_banded` makes per
band: the up sweep records the carry entering each band from below, and
the down sweep finishes a band in one launch (the downward directions
from the running carry, the upward ones from the recorded carry, E and W
inside the band) and reduces it with `_select_from_aggregated`. Band costs
are recomputed from image strips with 3 context rows and the global-edge
clamp (`_band_cost`). Rank 0's up-sweep output is never read, so its
launch is skipped, as the band driver skips the top band's: per frame,
2 n - 1 launches over the ranks, or n without upward paths.

The result equals `sgbm_disparity_banded` with bands of H / n rows; like
it, band-local float32 cost sums can differ from the whole frame's by an
ulp and flip a near tie on isolated pixels.
"""

from __future__ import annotations

import torch

from ..config import SGBMConfig
from ..ops.sgbm import SGBM_DIRECTIONS, _band_cost, _select_from_aggregated
from ..ops.sgbm_cuda import aggregate_paths_cuda
from .mesh import Mesh, as_input

__all__ = ["sgbm_pipeline_mesh"]

_CTX = 3  # the Sobel's row (1) + the block sum's radius (2)


def sgbm_pipeline_mesh(mesh: Mesh, cfg: SGBMConfig = SGBMConfig(), axis: str = "tile"):
    """Pipelined SGBM over the mesh's `axis` (n ranks, one band each).

    Returns fn(left, right): (B, H, W) float gray batches, the same on every
    rank, H divisible by n -> (disparity (B, H, W) float32, valid (B, H, W)
    bool) on every rank of the mesh (None on a rank outside it)."""
    if cfg.num_paths not in SGBM_DIRECTIONS:
        raise ValueError(f"num_paths must be 4, 5 or 8, got {cfg.num_paths}")
    p1, p2 = (float(p) for p in cfg.resolved_p1p2())
    dirs = SGBM_DIRECTIONS[cfg.num_paths]
    ndir = 3 if cfg.num_paths in (8, 5) else 1
    use_up = cfg.num_paths != 5  # MODE_SGBM has no upward paths

    def fn(left, right):
        if not mesh.member:
            return None
        n, k = mesh.size(axis), mesh.index(axis)
        left, right = as_input(left, mesh.device), as_input(right, mesh.device)
        b, h, w_full = left.shape
        if h % n:
            raise ValueError(f"{h} rows do not split into {n} bands ({axis})")
        hb = h // n
        margin = min(cfg.min_disp + cfg.num_disp, w_full)
        # every frame's rows with the context rows around the image clamped
        rows = torch.clamp(torch.arange(-_CTX, h + _CTX, device=left.device), 0, h - 1)
        lp, rp = left.index_select(1, rows), right.index_select(1, rows)

        def cost(f):  # this rank's band of frame f
            return _band_cost(lp[f], rp[f], k, hb, h, margin, cfg, _CTX)

        zero = torch.zeros((ndir, w_full - margin, cfg.num_disp), device=left.device)
        up_in = [zero] * b  # the upward carry entering this band from below, per frame
        if use_up:
            for f in range(b):
                carry = zero if k == n - 1 else mesh.recv(zero, axis, k + 1)
                up_in[f] = carry
                if k > 0:
                    out = torch.empty_like(zero)
                    aggregate_paths_cuda(cost(f), p1, p2, dirs[ndir:2 * ndir], carry, out,
                                         with_s=False)
                    mesh.send(out, axis, k - 1)

        disp, valid = [], []
        for f in range(b):
            down = zero if k == 0 else mesh.recv(zero, axis, k - 1)
            carry_in = torch.cat([down, up_in[f]]) if use_up else down
            carry_out = torch.empty_like(carry_in)
            s = aggregate_paths_cuda(cost(f), p1, p2, dirs, carry_in, carry_out)
            if k < n - 1:
                mesh.send(carry_out[:ndir], axis, k + 1)
            up_in[f] = None  # read once
            d_b, v_b, _ = _select_from_aggregated(s, cfg, margin, w_full)
            del s
            disp.append(d_b)
            valid.append(v_b)
        return mesh.gather(torch.stack(disp), axis, 1), mesh.gather(torch.stack(valid), axis, 1)

    return fn
