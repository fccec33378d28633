"""Halo exchange for row-tiled images (port of
`stereomatch_tpu/parallel/halo.py`: the reference's shared-memory row
tiling, src/PatchMatchStereoGPU.cu:1302-1346, as neighbour sends)."""

from __future__ import annotations

import torch

from .mesh import Mesh

__all__ = ["halo_exchange_rows"]


def halo_exchange_rows(x: torch.Tensor, halo: int, mesh: Mesh, axis: str = "tile") -> torch.Tensor:
    """Extend this rank's row block (Hs, ...) with `halo` rows from each
    neighbour along `axis`: (Hs + 2 halo, ...). The grid's edge blocks get
    zero rows (callers that need edge replication re-pad afterwards), and
    so does every block of a one-tile axis or with halo 0."""
    n = mesh.size(axis)
    if halo == 0 or n == 1:
        pad = x.new_zeros((halo,) + tuple(x.shape[1:]))
        return torch.cat([pad, x, pad])
    from_prev = mesh.shift(x[-halo:], axis, +1)  # the previous tile's last rows
    from_next = mesh.shift(x[:halo], axis, -1)  # the next tile's first rows
    return torch.cat([from_prev, x, from_next])
