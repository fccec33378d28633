"""SGBM over a mesh: frames in data parallel (port of
`stereomatch_tpu/parallel/sgbm_mesh.py`).

SGBM's DP couples every row to every other through the vertical and
diagonal paths, so one frame split over ranks becomes a pipeline
(sgbm_pipeline.py). A stream of frames splits by FRAME: each rank runs the
single-card engine, `ops.sgbm.sgbm_disparity` (kernel K1 on the card), on
its own frames.
"""

from __future__ import annotations

import torch

from ..config import SGBMConfig
from ..ops.sgbm import sgbm_disparity
from .mesh import Mesh, as_input

__all__ = ["sgbm_batch_mesh"]


def sgbm_batch_mesh(mesh: Mesh, cfg: SGBMConfig = SGBMConfig(), axis: str = "frame"):
    """Batched SGBM: (B, H, W) gray pairs split over the mesh's `axis`, B
    divisible by its size. Returns fn(left_batch, right_batch) ->
    (disparity (B, H, W) float32, valid (B, H, W) bool) on every rank of the
    mesh (None on a rank outside it)."""

    def fn(left_batch, right_batch):
        if not mesh.member:
            return None
        lb, rb = (mesh.shard(as_input(x, mesh.device), axis) for x in (left_batch, right_batch))
        outs = [sgbm_disparity(l, r, cfg) for l, r in zip(lb, rb)]
        disp = torch.stack([o.disparity for o in outs])
        valid = torch.stack([o.valid for o in outs])
        return mesh.gather(disp, axis), mesh.gather(valid, axis)

    return fn
