"""3DMST tree-filter aggregation and plane-label optimization (port of
`stereomatch_tpu/ops/mst.py`).

Every tree-edge weight is exp(-gamma * colour difference), so weight
products along tree paths telescope and the reference's two tree passes
become prefix sums: the leaf-to-root pass is a subtree sum (a contiguous
node range) and the root-to-leaf pass an ancestor sum (Euler +enter/-exit
prefix). Both run through kernel K2 on CUDA (`segmented_cumsum`, and
`ancestor_sums` with the Euler gathers fused), their twins on CPU, with
segments restarting at `seg_root` / `euler_reset`. Segment
depth ranges are bounded by `max_log_range`, and `carry_iters` rounds of
cross-cut carry injection restore aggregation across segment cuts.

Random candidates come from `stereomatch_tpu_torch.random`, bit-exact with
jax.random, so one key draws the same candidates as the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import MSTConfig
from .. import random as trandom
from .mst_scan_cuda import ancestor_sums, segmented_cumsum

__all__ = [
    "ForestArrays",
    "forest_arrays",
    "tree_filter",
    "aggregation_norm_inv",
    "label_cost",
    "labels_to_disparity",
    "plane_labels_from_disparity",
    "init_labels",
    "mst_pms_optimize",
    "refine_deltas",
    "make_candidate_fn",
]


class ForestArrays(NamedTuple):
    """Flat segment forest, from the host builder (`forest_arrays`) or
    the device builder (`ops.device_forest.device_forest_arrays`). Node
    order is per-segment DFS preorder, and every segment's nodes and Euler
    events are contiguous ranges. Index arrays are int64; the JAX
    version's scan maps are replaced by the two reset masks the scan takes
    directly."""

    pixel_of_node: torch.Tensor  # (N,)
    parent_node: torch.Tensor  # (N,) self at tree roots
    w_exp: torch.Tensor  # (N,) f32 weight to the parent (0 at roots)
    rel_gd: torch.Tensor  # (N,) f32 depth relative to the segment root
    in_pos: torch.Tensor  # (N,) Euler in-event position
    out_pos: torch.Tensor  # (N,) Euler out-event position
    tree_id: torch.Tensor  # (N,)
    seg_root: torch.Tensor  # (N,) bool: node scans restart here
    euler_reset: torch.Tensor  # (2N,) bool: Euler scans restart here
    euler_src: torch.Tensor  # (2N,) node of each Euler event
    euler_is_in: torch.Tensor  # (2N,) bool: in-event
    cut_child_idx: torch.Tensor  # (S, N) k-th cut child (self if none); S = 3 host, 4 device
    cut_child_w: torch.Tensor  # (S, N) f32 its w_exp (0 if none)
    tree_start: torch.Tensor  # (T+1,) node offsets; T = trees (host) or tmax (device)
    adj_start: torch.Tensor  # (T+1,) CSR offsets of neighbouring trees
    adj_list: torch.Tensor  # (M,)
    sub_end: torch.Tensor  # (N,) p's in-segment subtree = [p, sub_end)
    num_trees: int
    height: int
    width: int


def forest_arrays(forest, device: torch.device | str = "cuda") -> ForestArrays:
    """A host `native.Forest` as ForestArrays on `device`: int64 indices,
    bool masks, contiguous tensors. Unlike the device forest, the cut
    children take 3 slots (a grid tree node has at most 3 children; the
    device builder's tree roots need a 4th) and tree_start holds exactly
    the forest's T + 1 offsets, with num_trees = T."""
    n = forest.height * forest.width
    ar = np.arange(n, dtype=np.int64)
    seg_root = forest.seg_root_mask()
    in_pos = forest.in_pos.astype(np.int64)
    out_pos = forest.out_pos.astype(np.int64)
    euler_reset = np.zeros(2 * n, bool)
    euler_reset[in_pos[seg_root]] = True
    # every Euler position is the in- or out-event of exactly one node
    euler_src = np.zeros(2 * n, np.int64)
    euler_src[in_pos] = ar
    euler_src[out_pos] = ar
    euler_is_in = np.zeros(2 * n, bool)
    euler_is_in[in_pos] = True
    # cut children in gather form: only non-tree-root segment roots carry
    # across a cut, each into the node above it
    parent = forest.parent_node.astype(np.int64)
    sc_nodes = np.nonzero(seg_root & (parent != ar))[0]
    sc_parent = parent[sc_nodes]
    cut_child_idx = np.tile(ar, (3, 1))
    cut_child_w = np.zeros((3, n), np.float32)
    if sc_nodes.size:
        order = np.argsort(sc_parent, kind="stable")
        sp, sn = sc_parent[order], sc_nodes[order]
        first = np.concatenate([[True], sp[1:] != sp[:-1]])
        slot = np.arange(sp.size) - np.maximum.accumulate(np.where(first, np.arange(sp.size), 0))
        if slot.max() >= 3:
            raise ValueError("a grid tree node has more than 3 cut children")
        cut_child_idx[slot, sp] = sn
        cut_child_w[slot, sp] = forest.w_exp[sn]
    # a one-tree forest has no neighbours: keep adj_list non-empty so the
    # candidate gathers stay well-formed
    adj_list = forest.adj_list if forest.adj_list.size else np.zeros(1, np.int32)
    # p's in-segment subtree is the node range [p, sub_end): its Euler
    # bracket [in(p), out(p)] holds exactly its 2k events
    sub_end = ar + (out_pos - in_pos + 1) // 2

    def t(a):
        a = np.ascontiguousarray(a)
        if a.dtype != np.bool_ and np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(device)

    return ForestArrays(
        pixel_of_node=t(forest.pixel_of_node), parent_node=t(parent),
        w_exp=t(forest.w_exp), rel_gd=t(forest.rel_gd),
        in_pos=t(in_pos), out_pos=t(out_pos), tree_id=t(forest.tree_id), seg_root=t(seg_root),
        euler_reset=t(euler_reset), euler_src=t(euler_src), euler_is_in=t(euler_is_in),
        cut_child_idx=t(cut_child_idx), cut_child_w=t(cut_child_w),
        tree_start=t(forest.tree_start), adj_start=t(forest.adj_start), adj_list=t(adj_list),
        sub_end=t(sub_end), num_trees=int(forest.num_trees), height=int(forest.height),
        width=int(forest.width),
    )


def _subtree_sums(t: torch.Tensor, f: ForestArrays) -> torch.Tensor:
    """Sum over the in-segment subtree of p (the node range [p, sub_end))."""
    p = segmented_cumsum(t, f.seg_root)
    return p.index_select(-1, f.sub_end - 1) - (p - t)


def _ancestor_sums(v: torch.Tensor, f: ForestArrays) -> torch.Tensor:
    """Sum over in-segment ancestors-or-self, via the Euler +in/-out prefix
    (one K2 launch with its gathers fused on CUDA)."""
    return ancestor_sums(v, f.euler_src, f.euler_is_in, f.euler_reset, f.in_pos)


def tree_filter(c_node: torch.Tensor, f: ForestArrays, carry_iters: int = 2) -> torch.Tensor:
    """Tree-filter aggregation D for all trees at once: c_node (..., N)
    per-node costs in node order -> (..., N)."""
    e_neg = torch.exp(-f.rel_gd)
    e_pos = torch.exp(f.rel_gd)
    n = f.parent_node.shape[0]
    is_tree_root = f.parent_node == torch.arange(n, device=f.parent_node.device)
    w2c = 1.0 - f.w_exp * f.w_exp

    t0 = e_neg * c_node
    u = e_pos * _subtree_sums(t0, f)
    for _ in range(carry_iters):
        # node p receives w_c * U(c) from each of its cut children
        inj = f.cut_child_w[0] * u.index_select(-1, f.cut_child_idx[0])
        for s in range(1, f.cut_child_idx.shape[0]):
            inj = inj + f.cut_child_w[s] * u.index_select(-1, f.cut_child_idx[s])
        u = e_pos * _subtree_sums(t0 + e_neg * inj, f)

    def down(seed_root):
        v = torch.where(f.seg_root, seed_root, e_pos * w2c * u)
        return e_neg * _ancestor_sums(v, f)

    d = down(u)  # first pass: every segment root acts as a tree root
    for _ in range(carry_iters):
        d_par = d.index_select(-1, f.parent_node)
        d = down(torch.where(is_tree_root, u, f.w_exp * d_par + w2c * u))
    return d


def aggregation_norm_inv(f: ForestArrays, carry_iters: int = 2) -> torch.Tensor:
    """Per-node reciprocal of the tree-filtered ones volume (the
    reference's cost_norm_factor)."""
    return 1.0 / tree_filter(torch.ones_like(f.w_exp), f, carry_iters)


def _node_xy(f: ForestArrays, nodes=None):
    pix = f.pixel_of_node if nodes is None else f.pixel_of_node[nodes]
    return (pix % f.width).float(), torch.div(pix, f.width, rounding_mode="floor").float()


def label_cost(
    cost_vol: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    f: ForestArrays,
    max_disp: int,
    vol_in_node_order: bool = False,
) -> torch.Tensor:
    """Per-node data cost of plane labels: d = x a + y b + c, linearly
    interpolated in the (H, W, D) volume (or its (N, D) node-order rows);
    out-of-range planes cost 0.5. a/b/c: (..., N) in node order. The two
    lerp endpoints are read at a start clipped to D-2, as the JAX (1, 2)
    slice gather does; the lerp runs in float32 for a bf16 volume."""
    x, y = _node_xy(f)
    d = x * a + y * b + c
    if max_disp < 2:
        return torch.full(d.shape, 0.5, dtype=torch.float32, device=d.device)
    d_floor = torch.floor(d)
    lo = d_floor.long()
    in_range = (lo >= 0) & (lo + 1 < max_disp)
    nd = cost_vol.shape[-1]
    vol_flat = cost_vol.reshape(-1)
    n = f.pixel_of_node.shape[0]
    row = torch.arange(n, device=d.device) if vol_in_node_order else f.pixel_of_node
    idx = row * nd + torch.clamp(lo, 0, max_disp - 2)
    c_lo = vol_flat[idx].float()
    c_hi = vol_flat[idx + 1].float()
    frac = d - d_floor
    return torch.where(in_range, (1.0 - frac) * c_lo + frac * c_hi, d.new_full((), 0.5))


def _gradient(d: torch.Tensor, axis: int) -> torch.Tensor:
    """jnp.gradient along one axis: central differences, one-sided edges."""
    n = d.shape[axis]
    inner = (d.narrow(axis, 2, n - 2) - d.narrow(axis, 0, n - 2)) * 0.5
    first = d.narrow(axis, 1, 1) - d.narrow(axis, 0, 1)
    last = d.narrow(axis, n - 1, 1) - d.narrow(axis, n - 2, 1)
    return torch.cat([first, inner, last], dim=axis)


def plane_labels_from_disparity(disp_img: torch.Tensor, f: ForestArrays, smooth_radius: int = 2):
    """Per-node plane labels (a, b, c) from a per-pixel disparity image in
    pixels: box-smoothed (reflect-101), (a, b) its central-difference
    gradients, c = d - a x - b y."""
    from .filters import box_filter

    d = disp_img.float()
    if smooth_radius > 0:
        d = box_filter(d, smooth_radius, mode="reflect")
    b_img, a_img = _gradient(d, 0), _gradient(d, 1)
    pix = f.pixel_of_node
    x, y = _node_xy(f)
    df = d.reshape(-1)[pix]
    a = a_img.reshape(-1)[pix]
    b = b_img.reshape(-1)[pix]
    return a, b, df - a * x - b * y


def labels_to_disparity(a, b, c, f: ForestArrays, max_disp: int) -> torch.Tensor:
    """(H, W) disparity from node-order labels, normalized to [0, 1]:
    clamp01((x a + y b + c) / (max_disp - 1))."""
    x, y = _node_xy(f)
    d = torch.clamp((x * a + y * b + c) / (max_disp - 1.0), 0.0, 1.0)
    img = torch.zeros(f.height * f.width, dtype=torch.float32, device=d.device)
    img[f.pixel_of_node] = d
    return img.reshape(f.height, f.width)


def _sample_plane(key: torch.Tensor, px: torch.Tensor, py: torch.Tensor, d_max: float):
    """Random plane through (px, py): disparity uniform in [0, d_max), its
    normal from a uniform point of the unit disc lifted to the hemisphere.
    The three uniform draws are jax.random's bit for bit; cos, sin and sqrt
    may differ from XLA's by an ulp, which the division by nz magnifies."""
    k1, k2, k3 = trandom.split(key, 3)
    d = trandom.uniform(k1, px.shape) * d_max
    r = torch.sqrt(trandom.uniform(k2, px.shape))
    th = trandom.uniform(k3, px.shape) * (2.0 * math.pi)
    x1, x2 = r * torch.cos(th), r * torch.sin(th)
    s = torch.sqrt(torch.clamp(1.0 - x1 * x1 - x2 * x2, min=0.0))
    nx, ny = 2.0 * x1 * s, 2.0 * x2 * s
    nz = torch.sqrt(torch.clamp(1.0 - nx * nx - ny * ny, min=1e-8))
    return -nx / nz, -ny / nz, (nx * px + ny * py + nz * d) / nz


def init_labels(key: torch.Tensor, f: ForestArrays, max_disp: int):
    """Random per-node plane labels (a, b, c) in node order."""
    px, py = _node_xy(f)
    return _sample_plane(key, px, py, float(max_disp))


def refine_deltas(max_disp: int, start: float | None = None, device="cuda"):
    """Annealed refinement ladder: (deltas_d, deltas_n) float32, the
    disparity delta halving from Dmax/2 (or `start`) while > 0.1 with the
    normal delta halving alongside."""
    deltas = []
    md = 0.5 * max_disp if start is None else float(start)
    mn = min(1.0, md / (0.5 * max_disp))
    while md > 0.1:
        deltas.append((md, mn))
        md, mn = md * 0.5, mn * 0.5
    # built on the host and copied without a stream sync: a blocking copy
    # would make the host wait for every frame enqueued before it
    return (
        torch.tensor([d for d, _ in deltas], dtype=torch.float32).to(device, non_blocking=True),
        torch.tensor([m for _, m in deltas], dtype=torch.float32).to(device, non_blocking=True),
    )


def _draw_index(u: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """min(int(u * max(count, 1)), int(max(count - 1, 0))), float32 math."""
    return torch.minimum(
        (u * torch.clamp(count, min=1.0)).long(), torch.clamp(count - 1.0, min=0.0).long()
    )


def make_candidate_fn(key_i, a, b, c, f: ForestArrays, max_disp: int, max_neighbors: int,
                      deltas_d, deltas_n):
    """Per-iteration candidate generator: cand(j) -> per-tree (a, b, c),
    each (tmax,). j < max_neighbors: the label of a random node of a random
    neighbouring tree; otherwise annealed refinement level j - max_neighbors
    around one random node's label per tree. RNG is keyed by j, as in JAX."""
    tmax = f.tree_start.shape[0] - 1
    n = f.pixel_of_node.shape[0]
    dev = a.device
    n_refine = deltas_d.shape[0]
    tsize = (f.tree_start[1:] - f.tree_start[:-1]).float()
    nb_count = (f.adj_start[1:] - f.adj_start[:-1]).float()
    ka, kb, kc = trandom.split(key_i, 3)

    # base label for refinements, one random node per tree; empty padding
    # trees index one past the last node, clipped as JAX clips gathers
    u = trandom.uniform(kb, (tmax,))
    base_node = (f.tree_start[:-1] + _draw_index(u, tsize)).clamp(max=n - 1)
    pa, pb, pc = a[base_node], b[base_node], c[base_node]
    px, py = _node_xy(f, base_node)
    nz = 1.0 / torch.sqrt(pa * pa + pb * pb + 1.0)
    nx = -pa * nz
    ny = -pb * nz
    d0 = px * pa + py * pb + pc

    def cand(j: int):
        if j < max_neighbors:
            k1, k2 = trandom.split(trandom.fold_in(ka, j))
            un = trandom.uniform(k1, (tmax,))
            nb_idx = f.adj_start[:-1] + _draw_index(un, nb_count)
            nb_tree = torch.where(
                nb_count > 0,
                f.adj_list[nb_idx.clamp(0, f.adj_list.shape[0] - 1)],
                torch.arange(tmax, device=dev),
            )
            v = trandom.uniform(k2, (tmax,))
            nts = f.tree_start[nb_tree]
            ntc = (f.tree_start[nb_tree + 1] - nts).float()
            node = (nts + _draw_index(v, ntc)).clamp(max=n - 1)
            return a[node], b[node], c[node]
        jr = min(max(j - max_neighbors, 0), max(n_refine - 1, 0))
        r = trandom.uniform(trandom.fold_in(kc, jr), (4, tmax), -1.0, 1.0)
        dd, dn = deltas_d[jr], deltas_n[jr]
        rd = d0 + r[0] * dd
        rnx = nx + r[1] * dn
        rny = ny + r[2] * dn
        rnz = nz + r[3] * dn
        inv = 1.0 / torch.sqrt(rnx * rnx + rny * rny + rnz * rnz)
        rnx, rny = rnx * inv, rny * inv
        rnz = torch.clamp(torch.abs(rnz * inv), min=1e-8)
        ca = -rnx / rnz
        cb = -rny / rnz
        cc = (rnx * px + rny * py + rnz * rd) / rnz
        ok = (rd >= 0.0) & (rd <= max_disp)  # else keep the base label
        return torch.where(ok, ca, pa), torch.where(ok, cb, pb), torch.where(ok, cc, pc)

    return cand


def mst_pms_optimize(
    key: torch.Tensor,
    cost_vol: torch.Tensor,
    f: ForestArrays,
    cfg: MSTConfig = MSTConfig(),
    max_neighbors: int = 8,
    iterations: int | None = None,
    init_state=None,
    candidate_chunk: int | None = None,
    refine_start: float | None = None,
):
    """The MST_PMS loop for all trees at once, from `init_state` =
    (a, b, c, min_cost) in node order, or from random planes
    (init_labels) at an infinite min cost when it is None. Per iteration
    every candidate is evaluated through label_cost + tree_filter and each
    pixel keeps its best (ties to the smallest candidate index).
    candidate_chunk bounds peak memory by evaluating that many candidates
    at a time with a running min; the result is identical. Returns
    (a, b, c, min_cost)."""
    iters = cfg.iterations if iterations is None else iterations
    max_disp = cfg.max_disp
    dev = cost_vol.device
    vol_dtype = getattr(torch, cfg.volume_dtype)
    # node-order rows: every iteration's lerp reads consecutive rows
    vol = cost_vol.to(vol_dtype).reshape(-1, cost_vol.shape[-1])[f.pixel_of_node]
    deltas_d, deltas_n = refine_deltas(max_disp, refine_start, dev)
    k_total = max_neighbors + int(deltas_d.shape[0])
    inv_norm = aggregation_norm_inv(f, cfg.carry_iters) if cfg.normalize_aggregation else None

    key, k0 = trandom.split(key)
    if init_state is None:
        a, b, c = init_labels(k0, f, max_disp)
        mc = torch.full(a.shape, float("inf"), dtype=torch.float32, device=dev)
    else:
        a, b, c, mc = (torch.as_tensor(x, device=dev) for x in init_state)

    def eval_block(pa_, pb_, pc_):
        cn = label_cost(
            vol, pa_[:, f.tree_id], pb_[:, f.tree_id], pc_[:, f.tree_id], f, max_disp,
            vol_in_node_order=True,
        )
        agg = tree_filter(cn, f, cfg.carry_iters)
        return agg if inv_norm is None else agg * inv_norm

    for key_i in trandom.split(key, iters):
        cand = make_candidate_fn(key_i, a, b, c, f, max_disp, max_neighbors, deltas_d, deltas_n)
        params = [cand(j) for j in range(k_total)]
        ka_, kb_, kc_ = (torch.stack([p[i] for p in params]) for i in range(3))
        chunk = k_total if candidate_chunk is None else min(candidate_chunk, k_total)
        best_agg = best_k = None
        for j0 in range(0, k_total, chunk):
            agg = eval_block(ka_[j0 : j0 + chunk], kb_[j0 : j0 + chunk], kc_[j0 : j0 + chunk])
            lc, lk = agg.amin(0), torch.argmin(agg, 0) + j0
            if best_agg is None:
                best_agg, best_k = lc, lk
            else:  # strict: the first (smallest-j) minimum wins
                better_c = lc < best_agg
                best_agg = torch.where(better_c, lc, best_agg)
                best_k = torch.where(better_c, lk, best_k)
        better = best_agg < mc
        a = torch.where(better, ka_[best_k, f.tree_id], a)
        b = torch.where(better, kb_[best_k, f.tree_id], b)
        c = torch.where(better, kc_[best_k, f.tree_id], c)
        mc = torch.where(better, best_agg, mc)
    return a, b, c, mc
