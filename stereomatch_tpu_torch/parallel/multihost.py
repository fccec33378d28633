"""Multi-host composition: frames over hosts, tiles and slabs within a host
(port of `stereomatch_tpu/parallel/multihost.py`).

SURVEY §5's distributed design ends at the mesh (host, tile_y, tile_x,
dslab): stereo pairs spread over hosts, each frame's pixels and disparity
slabs over one host's cards.

  - `distributed_init` joins the process group a launcher describes in
    the environment (torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK
    and LOCAL_RANK); alone it does nothing, so one program runs on one card
    or many.
  - `make_host_mesh` builds the 4-axis mesh with the host axis slowest:
    torchrun numbers ranks host by host, so every collective inside a
    frame stays within one host, and only the frames' scatter and the
    maps' gather cross hosts.
  - `tiled2d_cost_volume_batch` runs tiled2d's pipeline over a
    host-split frame batch.

On the CPU it runs as spawned gloo processes (parallel/launch.py); the
tests hold a (2, 2, 2, 1) mesh of 8 processes to the whole-frame pipeline
frame by frame.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..config import CostVolumePipelineConfig
from .mesh import BACKENDS, Mesh, as_input
from .tiled2d import _body2d, _check_shape

__all__ = ["distributed_init", "make_host_mesh", "tiled2d_cost_volume_batch"]


def distributed_init(device: torch.device | str = "cuda") -> bool:
    """Join the process group that torchrun's environment describes, on
    `device`'s backend (NCCL for cuda, with this process on card
    LOCAL_RANK; gloo for cpu); True if a group was joined. A process with
    no such environment is alone: nothing happens and it returns False."""
    if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
        return False
    dev = torch.device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"a mesh runs on cuda (NCCL) or cpu (gloo), not {dev.type}")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(BACKENDS[dev.type], init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]),
                            timeout=datetime.timedelta(minutes=5))
    return True


def make_host_mesh(n_host: int, n_ty: int, n_tx: int, n_dslab: int,
                   device: torch.device | str = "cuda") -> Mesh:
    """A (host, tile_y, tile_x, dslab) mesh, the host axis varying slowest."""
    return Mesh({"host": n_host, "tile_y": n_ty, "tile_x": n_tx, "dslab": n_dslab}, device)


def tiled2d_cost_volume_batch(mesh: Mesh, shape: tuple[int, int],
                              cfg: CostVolumePipelineConfig = CostVolumePipelineConfig(),
                              denoise: bool = True, lr_check: bool = False):
    """The batched pipeline: (B, H, W, 3) frames split over "host" (B must
    divide by it), each frame over (tile_y, tile_x, dslab) as in
    `tiled2d_cost_volume_stereo`, lr_check included. Returns fn(left_batch,
    right_batch) -> the (B, H, W) maps of both views on every rank of the
    mesh (None on a rank outside it)."""
    halo = _check_shape(mesh, shape, cfg)

    def fn(left_batch, right_batch):
        if not mesh.member:
            return None
        lb, rb = (mesh.shard(mesh.shard(as_input(x, mesh.device), "host", 0), "tile_y", 1)
                  for x in (left_batch, right_batch))
        outs = [_body2d(l, r, cfg, denoise, halo, mesh, lr_check) for l, r in zip(lb, rb)]
        return tuple(
            mesh.gather(mesh.gather(mesh.gather(torch.stack([o[i] for o in outs]), "tile_x", 2),
                                    "tile_y", 1), "host", 0)
            for i in (0, 1))

    return fn
