"""The host segment-forest builder (port of `stereomatch_tpu/native/`).

treebuild.cpp is a byte-for-byte copy of the JAX package's builder
(tests/test_torch_native.py holds the two equal): Felzenszwalb
segmentation with the small-component merge, a Kruskal MST per component,
segment splits at weighted depth `delta`, and the merged DFS that numbers
nodes and Euler events segment-contiguously. It runs on the host once per
view and returns numpy arrays; `ops.mst.forest_arrays` moves them to the
device. Called through ctypes; the library is built with g++ at first use
(native/build.py), and a build or load that fails raises.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
from dataclasses import dataclass

import numpy as np

__all__ = ["Forest", "build_forest", "color_edge_weights"]

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


@functools.cache
def _load():
    from .build import build

    lib = ctypes.CDLL(build())
    lib.build_forest.restype = ctypes.c_int
    lib.build_forest.argtypes = (
        [ctypes.c_int, ctypes.c_int, _F32P, _F32P, ctypes.c_float, ctypes.c_int,
         ctypes.c_float, ctypes.c_float]
        + [_I32P, _I32P, _F32P, _F32P] + [_I32P] * 8 + [ctypes.c_int64, _I32P]
    )
    return lib


@dataclass
class Forest:
    """Flat segment-forest arrays in segment-contiguous DFS (Euler) order.

    Node order is tree-major then segment-major DFS; a segment's Euler
    events occupy a contiguous range of [0, 2N). `parent_node` of a segment
    root points at the node above the cut (tree roots point at themselves,
    w_exp=0); `rel_gd` is gamma * weighted depth within the segment
    (<= delta by construction)."""

    height: int
    width: int
    pixel_of_node: np.ndarray  # (N,) int32
    parent_node: np.ndarray  # (N,) int32
    w_exp: np.ndarray  # (N,) float32, exp(-gamma * edge_w)
    rel_gd: np.ndarray  # (N,) float32
    in_pos: np.ndarray  # (N,) int32
    out_pos: np.ndarray  # (N,) int32
    seg_id: np.ndarray  # (N,) int32
    tree_id: np.ndarray  # (N,) int32
    node_of_pixel: np.ndarray  # (N,) int32
    tree_start: np.ndarray  # (T+1,) int32
    adj_start: np.ndarray  # (T+1,) int32 directed CSR over trees
    adj_list: np.ndarray  # (M,) int32
    num_trees: int
    num_segments: int

    @property
    def num_nodes(self) -> int:
        return self.height * self.width

    def seg_root_mask(self) -> np.ndarray:
        """First node of each segment: the seg_id transitions (not
        rel_gd == 0, which flat regions give everywhere)."""
        mask = np.empty(len(self.seg_id), bool)
        mask[0] = True
        mask[1:] = self.seg_id[1:] != self.seg_id[:-1]
        return mask


def build_forest(
    edge_w_right: np.ndarray,
    edge_w_down: np.ndarray,
    c: float,
    min_size: int,
    gamma: float,
    delta: float = 40.0,
) -> Forest:
    """Segment and build the MST forest from 4-neighbour edge weights:
    edge_w_right (H, W-1) between (y, x)-(y, x+1), edge_w_down (H-1, W)
    between (y, x)-(y+1, x). Raises RuntimeError when the library cannot
    be built or loaded."""
    h, wm1 = edge_w_right.shape
    hm1, w = edge_w_down.shape
    if wm1 != w - 1 or hm1 != h - 1:
        raise ValueError(f"edge weight shapes {edge_w_right.shape} and {edge_w_down.shape} "
                         "are not (H, W-1) and (H-1, W)")
    try:
        lib = _load()
    except (OSError, subprocess.CalledProcessError) as exc:  # no g++, or no loadable .so
        raise RuntimeError(
            f"native forest builder unavailable ({exc!r}): native/build.py builds "
            "treebuild.cpp with g++") from exc
    n = h * w
    wr = np.ascontiguousarray(edge_w_right, np.float32)
    wd = np.ascontiguousarray(edge_w_down, np.float32)
    i32 = lambda k: np.zeros(k, np.int32)  # noqa: E731
    f32 = lambda k: np.zeros(k, np.float32)  # noqa: E731
    pixel_of_node, parent_node = i32(n), i32(n)
    w_exp, rel_gd = f32(n), f32(n)
    in_pos, out_pos, seg_id, tree_id, node_of_pixel = i32(n), i32(n), i32(n), i32(n), i32(n)
    tree_start, adj_start = i32(n + 1), i32(n + 1)
    adj_cap = 4 * n + 16
    adj_list = i32(adj_cap)
    counts = i32(3)

    def ptr(a):
        return a.ctypes.data_as(_F32P if a.dtype == np.float32 else _I32P)

    ret = lib.build_forest(
        h, w, ptr(wr), ptr(wd), float(c), int(min_size), float(gamma), float(delta),
        ptr(pixel_of_node), ptr(parent_node), ptr(w_exp), ptr(rel_gd), ptr(in_pos),
        ptr(out_pos), ptr(seg_id), ptr(tree_id), ptr(node_of_pixel), ptr(tree_start),
        ptr(adj_start), ptr(adj_list), adj_cap, ptr(counts),
    )
    if ret != 0:
        raise RuntimeError(f"build_forest failed with code {ret}")
    num_trees, num_segments, num_adj = map(int, counts)
    return Forest(
        height=h, width=w, pixel_of_node=pixel_of_node, parent_node=parent_node,
        w_exp=w_exp, rel_gd=rel_gd, in_pos=in_pos, out_pos=out_pos, seg_id=seg_id,
        tree_id=tree_id, node_of_pixel=node_of_pixel,
        tree_start=tree_start[: num_trees + 1], adj_start=adj_start[: num_trees + 1],
        adj_list=adj_list[:num_adj], num_trees=num_trees, num_segments=num_segments,
    )


def color_edge_weights(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """L1 colour-difference edge weights (right, down) of an (H, W, C) or
    (H, W) image."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    wr = np.abs(img[:, 1:] - img[:, :-1]).sum(-1)
    wd = np.abs(img[1:, :] - img[:-1, :]).sum(-1)
    return wr, wd
