"""State carried across from the JAX package, as numpy arrays.

This system has no weights: the state a frame depends on is the segment
forest, the RNG key, PatchMatch's plane maps and, for the video server,
the maps and forests it chains from frame to frame. These converters let that state feed both
packages, so a comparison isolates the code under test. None imports jax;
the caller hands over `np.asarray` copies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .native import Forest
from .ops.device_forest import check_forest_capacity
from .ops.mst import ForestArrays

__all__ = ["forest_dict_from_numpy", "forest_from_numpy", "key_from_jax",
           "native_forest_from_numpy", "plane_state_from_numpy", "video_state_from_jax"]

# the entries of the port's build_forest_device dict: the ForestArrays
# tensors and three more; the JAX dict also holds its scan maps, which the
# port does not use
_RAW_KEYS = tuple(k for k in ForestArrays._fields if k not in ("num_trees", "height", "width")) + (
    "num_trees_actual", "adj_total", "labels")


def _tensor(a, device) -> torch.Tensor:
    """A copy of `a`: integer arrays become int64, masks bool, floats float32."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        t = torch.from_numpy(a.copy())
    elif np.issubdtype(a.dtype, np.integer):
        t = torch.from_numpy(a.astype(np.int64))
    else:
        t = torch.from_numpy(a.astype(np.float32))
    return t.to(device)


def forest_dict_from_numpy(raw: dict, device: torch.device | str = "cuda") -> dict:
    """The port's raw forest dict (what `_view_forest` returns, and what the
    video server chains) from the numpy copy of a JAX `build_forest_device`
    dict. Its capacities are checked here, as `_view_forest` checks its own
    (the tree capacity is len(tree_start) - 1)."""
    missing = [k for k in _RAW_KEYS if k not in raw]
    if missing:
        raise KeyError(f"not a build_forest_device dict: missing {missing}")
    out = {k: _tensor(raw[k], device) for k in _RAW_KEYS}
    check_forest_capacity(out, out["tree_start"].shape[0] - 1)
    return out


def forest_from_numpy(raw: dict, height: int, width: int, tmax: int,
                      device: torch.device | str = "cuda") -> ForestArrays:
    """ForestArrays from the numpy copy of the JAX `build_forest_device`
    dict ({name: np.asarray(array)}); the JAX scan maps are not needed."""
    fields = {k: _tensor(raw[k], device) for k in ForestArrays._fields if k in raw}
    return ForestArrays(**fields, num_trees=tmax, height=height, width=width)


def native_forest_from_numpy(fields: dict) -> Forest:
    """The port's host `native.Forest` from {field: value}, such as
    `dataclasses.asdict` of a JAX `native.Forest`: arrays as int32 or
    float32 copies, sizes as ints. `ops.mst.forest_arrays` uploads it."""
    kw = {}
    for f in dataclasses.fields(Forest):
        v = fields[f.name]
        if f.type == "int":
            kw[f.name] = int(v)
        else:
            a = np.asarray(v)
            kw[f.name] = a.astype(np.float32 if a.dtype.kind == "f" else np.int32)
    return Forest(**kw)


def key_from_jax(key, device: torch.device | str = "cuda") -> torch.Tensor:
    """The port's key (int64 (2,)) from a raw JAX key (uint32[2])."""
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"expected a raw uint32[2] key, got {k.dtype}{list(k.shape)}")
    return torch.from_numpy(k.astype(np.int64)).to(device)


def plane_state_from_numpy(nx, ny, d, device: torch.device | str = "cuda"):
    """The port's `ops.patchmatch.PlaneState` from numpy copies of a JAX
    PlaneState's (nx, ny, d) maps, as float32."""
    from .ops.patchmatch import PlaneState

    return PlaneState(*(_tensor(np.asarray(a, np.float32), device) for a in (nx, ny, d)))


def video_state_from_jax(server, prev, prev_forest, since_key: int, key_frac: float | None,
                         prev_ticket: int | None) -> None:
    """Install a JAX `VideoStreamServer`'s chained state into the port's
    `server`, from numpy copies of its `_prev` ((disp_l, disp_r) or None),
    `_prev_forest` ((raw_l, raw_r) dicts or None), `_since_key`,
    `_key_frac` and `_prev_ticket`. The next ticket follows `prev_ticket`,
    so a frame submitted without a seed gets the key JAX would give it."""
    dev = server.device
    server._prev = None if prev is None else tuple(_tensor(d, dev) for d in prev)
    server._prev_forest = None if prev_forest is None else tuple(
        forest_dict_from_numpy(f, dev) for f in prev_forest)
    server._since_key = int(since_key)
    server._key_frac = None if key_frac is None else float(key_frac)
    server._prev_ticket = prev_ticket
    if prev_ticket is not None:
        server._next = prev_ticket + 1
