"""Process groups on named mesh axes (port of `stereomatch_tpu/parallel/mesh.py`).

The JAX package lays a `jax.sharding.Mesh` over devices and runs one
`shard_map` body per device. Here each rank of the default
`torch.distributed` process group is one process on one device, and a
`Mesh` arranges the ranks on a grid of named axes, with one process group
for each line of the grid along each axis. The bodies' collectives become
calls on those groups:

  ppermute                 -> `Mesh.shift` (`batch_isend_irecv` with the neighbours;
                              `send` / `recv` where a sweep hands a carry on)
  pmin, psum               -> `Mesh.all_reduce` (`ReduceOp.MIN`, `ReduceOp.SUM`)
  all_gather(tiled=True)   -> `Mesh.gather` (`all_gather` of the blocks)
  axis_index               -> `Mesh.index`, the rank in the axis group

The backend follows the device, NCCL for `cuda` and gloo for `cpu`, and
nothing falls back from one to the other. Where no process group exists,
the first mesh starts a one-rank group on the device (the counterpart of
`jax.devices()` in one process); `multihost.distributed_init` joins the
group a launcher such as torchrun describes.
"""

from __future__ import annotations

import datetime
import functools
import math

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["BACKENDS", "Mesh", "as_input", "make_mesh", "process_group_device",
           "tile_rows_sharding"]

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def process_group_device(device: torch.device | str = "cuda") -> torch.device:
    """This rank's device of `device`'s type, after checking that the
    default process group runs that type's backend; with no process group,
    a one-rank group is started on an in-process store."""
    dev = torch.device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"a mesh runs on cuda (NCCL) or cpu (gloo), not {dev.type}")
    backend = BACKENDS[dev.type]
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=60))
    elif backend not in dist.get_backend():
        raise RuntimeError(f"the process group runs {dist.get_backend()}; {dev.type} tensors "
                           f"need {backend}")
    return dev


def as_input(x, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A numpy array or tensor as a `dtype` tensor on `device`."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


class Mesh:
    """The first prod(axes.values()) ranks of the default process group on a
    row-major grid of named axes (the last axis varies fastest, as in the
    JAX package's `np.array(devices).reshape(...)`). Every rank of the
    group builds every mesh, in the same order: each axis line is a
    process group, and `torch.distributed.new_group` is collective. A rank
    past the grid is no member (`member` False): the builders return None
    there, as a device left out of a JAX mesh computes nothing."""

    def __init__(self, axes: dict[str, int], device: torch.device | str = "cuda"):
        self.device = process_group_device(device)
        self.axis_names = tuple(axes)
        self.shape = {k: int(v) for k, v in axes.items()}
        sizes = tuple(self.shape.values())
        size, world, rank = math.prod(sizes), dist.get_world_size(), dist.get_rank()
        if min(sizes, default=1) < 1 or size > world:
            raise ValueError(f"mesh {self.shape} needs {size} ranks; the group has {world}")
        grid = np.arange(size).reshape(sizes)
        self.member = rank < size
        self._index = dict(zip(self.axis_names, (int(i) for i in np.unravel_index(rank, sizes)))
                           ) if self.member else {}
        self._groups, self._ranks = {}, {}
        for i, name in enumerate(self.axis_names):
            for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]).tolist():
                group = dist.new_group(line)
                if rank in line:
                    self._groups[name], self._ranks[name] = group, line

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's position along `axis` (JAX's `lax.axis_index`)."""
        return self._index[axis]

    def shard(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """This rank's contiguous block of `x` along `dim`, split over `axis`
        (a `PartitionSpec` entry of shard_map's in_specs)."""
        n, i = self.size(axis), self.index(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ({axis})")
        m = x.shape[dim] // n
        return x.narrow(dim, i * m, m)

    def gather(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The blocks of every rank along `axis`, concatenated in axis order
        along `dim` (`lax.all_gather(..., tiled=True)`); bool as uint8."""
        src = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
        blocks = [torch.empty_like(src) for _ in range(self.size(axis))]
        dist.all_gather(blocks, src, group=self._groups[axis])
        out = torch.cat(blocks, dim)
        return out.bool() if x.dtype == torch.bool else out

    def all_reduce(self, x: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """A reduced copy of `x` over `axis` (`lax.pmin` with ReduceOp.MIN,
        `lax.psum` with ReduceOp.SUM)."""
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=op, group=self._groups[axis])
        return out

    def shift(self, x: torch.Tensor, axis: str, step: int) -> torch.Tensor:
        """JAX's `ppermute` by `step` along `axis`: the rank at index i sends
        `x` to i + step and returns what i - step sent. Where no rank sends
        (the grid's edge) the result is zeros, built here with no receive
        posted, and a rank with no receiver posts no send."""
        n, i = self.size(axis), self.index(axis)
        out = torch.zeros_like(x, memory_format=torch.contiguous_format)
        group, ranks = self._groups[axis], self._ranks[axis]
        ops = []
        if 0 <= i + step < n:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[i + step], group))
        if 0 <= i - step < n:
            ops.append(dist.P2POp(dist.irecv, out, ranks[i - step], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def send(self, x: torch.Tensor, axis: str, to: int) -> None:
        """Send `x` to the rank at index `to` along `axis`."""
        dist.send(x.contiguous(), self._ranks[axis][to], group=self._groups[axis])

    def recv(self, like: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """Receive a tensor shaped as `like` from the rank at index `src`."""
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        dist.recv(out, self._ranks[axis][src], group=self._groups[axis])
        return out


def make_mesh(n_tile: int | None = None, n_frame: int = 1,
              device: torch.device | str = "cuda") -> Mesh:
    """A (frame, tile) mesh. Default: every rank on the tile axis."""
    process_group_device(device)
    if n_tile is None:
        n_tile = dist.get_world_size() // n_frame
    return Mesh({"frame": n_frame, "tile": n_tile}, device)


def tile_rows_sharding(mesh: Mesh):
    """Images (H, W[, C]) sharded by rows over the tile axis: a function
    giving this rank its rows (JAX: `NamedSharding(mesh, P("tile"))`)."""
    return functools.partial(mesh.shard, axis="tile", dim=0)
