"""On-device 3DMST forest construction: partition -> MST -> Euler tour
(port of `stereomatch_tpu/ops/device_forest.py`).

Stages, as in the JAX module:
1. partition: `ops.segmentation.boruvka_segment`;
2. per-component minimum spanning forest: Boruvka rounds on
   (weight, edge id) ranks, so the forest is unique;
3. rooted Euler tour: arcs in R, D, L, U circular order around each pixel,
   one Wyllie list ranking for tour positions, parents from down arcs,
   depths by ancestor pointer doubling;
4. band segment split: cut v iff floor(gd(v)/delta) != floor(gd(parent)/delta);
5. node order: sort by (segment discovery preorder, tree preorder), Euler
   in/out positions in closed form.

Every integer array equals the JAX module's; `gd` is summed in the same
pairwise doubling order, so the band cuts agree bit for bit. Indices are
int64 and the JAX module's float32-packed pointer rows are plain gathers.
Sorts on two keys become one sort of an int64 composite key. JAX clamps
out-of-range gathers and drops out-of-range scatters; here every such
index is clipped or masked explicitly. Fixpoint loops are capped Python
loops that raise at the cap (the JAX loops have none).
"""

from __future__ import annotations

import torch

from .mst import ForestArrays
from .segmentation import (
    _BIG_RANK,
    _at_ea,
    _at_eb,
    _edge_rank_tables,
    _min_rank_at_roots,
    _pointer_jump_conv as _compress_conv,
    boruvka_segment,
    ceil_log2,
)

__all__ = ["build_forest_device", "check_forest_capacity", "device_forest_arrays"]


def _grid_edges_idx(h: int, w: int, device):
    """Flat endpoints of the grid edges: right edges first, then down."""
    ir = torch.arange(h * (w - 1), device=device)
    a_r = (ir // (w - 1)) * w + ir % (w - 1)
    idn = torch.arange((h - 1) * w, device=device)
    return torch.cat([a_r, idn]), torch.cat([a_r + 1, idn + w])


def _component_mst(lab, ea, eb, ew, n: int, rank_tables, hw):
    """(E,) bool: edge is in the Boruvka minimum spanning forest of its
    label component. Every cluster hooks every round (mutual minima hook
    the larger root), so clusters at least halve per round."""
    h, w = hw
    e = ea.shape[0]
    dev = lab.device
    me = torch.arange(n, device=dev)
    same = _at_ea(lab, h, w) == _at_eb(lab, h, w)
    rank, eid_by_rank = rank_tables
    big = torch.full((), _BIG_RANK, dtype=rank.dtype, device=dev)
    parent = me
    tree = torch.zeros(e, dtype=torch.bool, device=dev)
    cap = ceil_log2(n) + 1
    for _ in range(cap):
        ra, rb = _at_ea(parent, h, w), _at_eb(parent, h, w)
        ok = same & (ra != rb)
        best_r = _min_rank_at_roots(n, ra, rb, torch.where(ok, rank, big))
        has = best_r < _BIG_RANK
        be = eid_by_rank[best_r.clamp(0, e - 1)]
        ra_e, rb_e = ra[be], rb[be]
        other = torch.where(ra_e == me, rb_e, ra_e)
        mutual = other[other.clamp(0, n - 1)] == me
        hooked = has & (parent == me) & ~(mutual & (me < other))
        # the hooking root's chosen edge is in the MST (cut property)
        tree[be[hooked]] = True
        parent = _compress_conv(torch.where(hooked, other, parent))
        if not bool(hooked.any()):
            return tree
    raise RuntimeError(f"component MST did not converge in {cap} rounds")


def _incidence(h: int, w: int, er: int, device):
    """(4, N) outgoing arc id per pixel in R, D, L, U slot order (-1 off
    grid; arc = edge for a->b, edge + E for b->a)."""
    n = h * w
    e = er + (h - 1) * w
    p = torch.arange(n, device=device)
    ys, xs = p // w, p % w
    right = ys * (w - 1) + xs
    down = er + p
    neg = torch.full((n,), -1, dtype=torch.int64, device=device)
    return torch.stack([
        torch.where(xs < w - 1, right, neg),
        torch.where(ys < h - 1, down, neg),
        torch.where(xs > 0, right - 1 + e, neg),
        torch.where(ys > 0, down - w + e, neg),
    ])


def _euler_tour(tree_edge, lab, ea, eb, h: int, w: int):
    """Tour positions, parents and subtree sizes from the forest edges."""
    n = h * w
    er = h * (w - 1)
    e = ea.shape[0]
    na = 2 * e
    dev = lab.device
    out_arc = _incidence(h, w, er, dev)
    aid = torch.arange(na, device=dev)
    edge_of = torch.where(aid < e, aid, aid - e)
    fwd = aid < e
    tail = torch.cat([ea, eb])
    head = torch.cat([eb, ea])
    live = torch.cat([tree_edge, tree_edge])

    # slot of the arc's edge at its head pixel
    is_right = edge_of < er
    in_slot = torch.where(
        fwd,
        torch.where(is_right, 2, 3),
        torch.where(is_right, 0, 1),
    )
    ter = tree_edge[:er].reshape(h, w - 1)
    ted = tree_edge[er:].reshape(h - 1, w)
    fr = ter.new_zeros(h, 1)
    fd = ted.new_zeros(1, w)
    inc_live = torch.stack([
        torch.cat([ter, fr], 1).reshape(-1),  # R: off at x = w-1
        torch.cat([ted, fd], 0).reshape(-1),  # D: off at y = h-1
        torch.cat([fr, ter], 1).reshape(-1),  # L: off at x = 0
        torch.cat([fd, ted], 0).reshape(-1),  # U: off at y = 0
    ])
    slot_arc = torch.where(inc_live, out_arc, -1).T.contiguous()  # (N, 4)
    arcs4 = torch.cat([_at_eb(slot_arc, h, w), _at_ea(slot_arc, h, w)])  # (na, 4)
    # successor: the next live outgoing slot after in_slot, cyclically
    succ = torch.full((na,), -1, dtype=torch.int64, device=dev)
    taken = torch.zeros(na, dtype=torch.bool, device=dev)
    for off in range(1, 5):
        k = (in_slot + off) % 4
        cand = torch.gather(arcs4, 1, k[:, None])[:, 0]
        ok = ~taken & (cand >= 0)
        succ = torch.where(ok, cand, succ)
        taken = taken | ok

    first_out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for k in (3, 2, 1, 0):  # the first live slot wins
        first_out = torch.where(inc_live[k], out_arc[k], first_out)
    root_of_arc = torch.cat([_at_ea(lab, h, w), _at_eb(lab, h, w)])
    start_arc = first_out[root_of_arc]
    nxt = torch.where(live & (succ != start_arc), succ, -1)

    # Wyllie suffix counts over the live arcs only (compacted)
    m = 2 * n
    cpos = torch.cumsum(live.long(), 0) - 1
    has_nxt = live & (nxt >= 0)
    cnxt = torch.full((m,), -1, dtype=torch.int64, device=dev)
    cnxt[cpos[live]] = torch.where(has_nxt, cpos[nxt.clamp(0, na - 1)], -1)[live]
    ccnt = torch.zeros(m, dtype=torch.int64, device=dev)
    ccnt[cpos[live]] = 1
    v, p = ccnt, cnxt
    for _ in range(ceil_log2(m) + 1):  # the JAX loop's own bound
        has = p >= 0
        if not bool(has.any()):
            break
        pc = p.clamp(0, m - 1)
        v = v + torch.where(has, v[pc], 0)
        p = torch.where(has, p[pc], -1)
    else:
        if bool((p >= 0).any()):
            raise RuntimeError("Wyllie list ranking did not converge")
    cnt = torch.where(live, v[cpos.clamp(0, m - 1)], 0)
    tsize = torch.bincount(lab, minlength=n)  # per ROOT pixel
    arcs_tree = 2 * (tsize[root_of_arc] - 1)
    pos = torch.where(live, arcs_tree - cnt, -1)

    # a down arc precedes its reverse: the discovery arc of its head
    pos_rev = torch.cat([pos[e:], pos[:e]])
    down = live & (pos < pos_rev)
    parent = torch.arange(n, device=dev)
    parent[head[down]] = tail[down]
    tsub = tsize[lab]  # roots: whole tree
    tsub[head[down]] = torch.div(pos_rev - pos + 1, 2, rounding_mode="floor")[down]
    return {
        "edge_of": edge_of,
        "down": down,
        "head": head,
        "pos": pos,
        "parent": parent,
        "tsub": tsub,
        "tsize_root": tsize,
    }


def _ancestor_doubling(parent: torch.Tensor, d_int: torch.Tensor, gd: torch.Tensor):
    """Sum per-node values along the ancestor chain by pointer doubling,
    to convergence: each round adds the current ancestor's partial sum,
    then doubles the pointer — the JAX module's order, so the float32 sums
    are bitwise the same."""
    anc = parent
    cap = ceil_log2(parent.shape[0]) + 1
    for _ in range(cap):
        anc2 = anc[anc]
        d_int = d_int + d_int[anc]
        gd = gd + gd[anc]
        done = torch.equal(anc2, anc)
        anc = anc2
        if done:
            return d_int, gd
    raise RuntimeError(f"ancestor doubling did not converge in {cap} rounds")


def _bincount_drop(idx: torch.Tensor, size: int) -> torch.Tensor:
    """zeros(size).at[idx].add(1) with out-of-range indices dropped."""
    return torch.bincount(idx[idx < size], minlength=size)[:size]


def build_forest_device(
    wr: torch.Tensor,
    wd: torch.Tensor,
    c: float = 5000.0,
    min_size: int = 200,
    gamma: float = 1.0 / 12.0,
    delta: float = 4.0,
    tmax: int = 4096,
    adj_cap: int = 32768,
    seg_rounds: int = 12,
    seg_merge_rounds: int = 6,
) -> dict:
    """Segment and build the MST forest on the weights' device (stages
    1-5). wr: (H, W-1) right-edge weights, wd: (H-1, W) down-edge weights.
    tmax / adj_cap: static tree and adjacency capacities (as JAX). Returns
    the raw per-node / per-tree arrays; wrap with device_forest_arrays."""
    h = wr.shape[0]
    w = wd.shape[1]
    n = h * w
    dev = wr.device
    ea, eb = _grid_edges_idx(h, w, dev)
    ew = torch.cat([wr.reshape(-1), wd.reshape(-1)]).float()
    rank_tables = _edge_rank_tables(ew)

    lab = boruvka_segment(
        wr, wd, c, min_size, rounds=seg_rounds, merge_rounds=seg_merge_rounds,
        rank_tables=rank_tables,
    ).reshape(-1)
    lab = _compress_conv(lab)
    tree_edge = _component_mst(lab, ea, eb, ew, n, rank_tables, (h, w))

    t = _euler_tour(tree_edge, lab, ea, eb, h, w)
    parent, tsub = t["parent"], t["tsub"]
    down, head, pos, edge_of = t["down"], t["head"], t["pos"], t["edge_of"]
    tsize_root = t["tsize_root"]
    pixels = torch.arange(n, device=dev)

    pw = torch.zeros(n, dtype=torch.float32, device=dev)
    pw[head[down]] = ew[edge_of[down]]
    is_root = parent == pixels
    gamma32 = torch.tensor(gamma, dtype=torch.float32, device=dev)
    d_int, gd = _ancestor_doubling(parent, (~is_root).long(), gamma32 * pw)

    # preorder within tree: (discovery position + 1 + depth) / 2
    disc_pos = torch.full((n,), -1, dtype=torch.int64, device=dev)
    disc_pos[head[down]] = pos[down]
    pre = torch.where(is_root, 0, torch.div(disc_pos + 1 + d_int, 2, rounding_mode="floor"))

    root_sizes = torch.where(is_root, tsize_root, 0)
    tree_rank = (torch.cumsum(is_root.long(), 0) - 1)[lab]
    pre_g = (torch.cumsum(root_sizes, 0) - root_sizes)[lab] + pre

    # stage 4: band segment split
    inv_delta = torch.tensor(1.0 / delta, dtype=torch.float32, device=dev)
    band = torch.floor(gd * inv_delta).long()
    segroot_mask = is_root | (band != band[parent])
    sr = _compress_conv(torch.where(segroot_mask, pixels, parent))
    rel_gd = gd - gd[sr]
    seg_depth = d_int - d_int[sr]
    seg_key = pre_g[sr]

    # stage 5: node order = sort by (segment, preorder); pre_g is unique
    kmul = 2 * n + 1  # > any preorder query below
    skey, pix_s = torch.sort(seg_key * kmul + pre_g)
    seg_s = seg_key[pix_s]
    pre_s = pre_g[pix_s]
    node_of_pixel = torch.empty_like(pix_s)
    node_of_pixel[pix_s] = pixels
    root_n = is_root[pix_s]
    parent_node = torch.where(root_n, pixels, node_of_pixel[parent[pix_s]])
    w_exp = torch.where(
        root_n, torch.zeros((), device=dev), torch.exp(-gamma32 * pw[pix_s])
    )
    seg_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), seg_s[1:] != seg_s[:-1]])
    seg_start = torch.cummax(torch.where(seg_first, pixels, 0), 0).values
    # within-segment subtree end: lower bound of (segment, pre + subtree size)
    s_end = torch.searchsorted(skey, seg_s * kmul + pre_s + tsub[pix_s])
    s_sz = s_end - pixels
    in_pos = 2 * seg_start + 2 * (pixels - seg_start) - seg_depth[pix_s]
    out_pos = in_pos + 2 * s_sz - 1

    tree_id_n = tree_rank[pix_s]
    counts = torch.bincount(tree_id_n.clamp(0, tmax - 1), minlength=tmax)
    zero1 = torch.zeros(1, dtype=torch.int64, device=dev)
    tree_start = torch.cat([zero1, torch.cumsum(counts, 0)])

    # inter-tree adjacency: unique (lo, hi) tree-rank pairs -> directed CSR
    ta, tb = _at_ea(tree_rank, h, w), _at_eb(tree_rank, h, w)
    crossing = ta != tb
    lo = torch.where(crossing, torch.minimum(ta, tb), tmax)
    hi = torch.where(crossing, torch.maximum(ta, tb), tmax)
    vmul = max(n, tmax) + 1
    pair = torch.sort(lo * vmul + hi).values
    lo_s, hi_s = pair // vmul, pair % vmul
    uniq = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1]),
    ]) & (lo_s < tmax)
    deg = (
        _bincount_drop(torch.where(uniq, lo_s, tmax), tmax + 1)
        + _bincount_drop(torch.where(uniq, hi_s, tmax), tmax + 1)
    )[:tmax]
    adj_start = torch.cat([zero1, torch.cumsum(deg, 0)])
    src = torch.cat([torch.where(uniq, lo_s, tmax), torch.where(uniq, hi_s, tmax)])
    dst = torch.cat([torch.where(uniq, hi_s, tmax), torch.where(uniq, lo_s, tmax)])
    dst_s = torch.sort(src * vmul + dst).values % vmul
    adj_list = torch.clamp(dst_s[:adj_cap], max=tmax - 1)

    # cut-child gather maps (4 slots: a tree root can have 4 cut children)
    sc = seg_first & ~root_n
    ckey = torch.where(sc, parent_node, n)
    ck_pair = torch.sort(ckey * (n + 1) + pixels).values
    ck_s, cn_s = ck_pair // (n + 1), ck_pair % (n + 1)
    run_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ck_s[1:] != ck_s[:-1]])
    slot = pixels - torch.cummax(torch.where(run_first, pixels, 0), 0).values
    okc = (ck_s < n) & (slot < 4)
    cut_child_idx = pixels.repeat(4, 1)
    cut_child_w = torch.zeros((4, n), dtype=torch.float32, device=dev)
    cut_child_idx[slot[okc], ck_s[okc]] = cn_s[okc]
    cut_child_w[slot[okc], ck_s[okc]] = w_exp[cn_s[okc]]

    euler_reset = torch.zeros(2 * n, dtype=torch.bool, device=dev)
    euler_reset[in_pos[seg_first]] = True
    euler_src = torch.zeros(2 * n, dtype=torch.int64, device=dev)
    euler_src[in_pos] = pixels
    euler_src[out_pos] = pixels
    euler_is_in = torch.zeros(2 * n, dtype=torch.bool, device=dev)
    euler_is_in[in_pos] = True

    return {
        "pixel_of_node": pix_s,
        "parent_node": parent_node,
        "w_exp": w_exp,
        "rel_gd": rel_gd[pix_s],
        "in_pos": in_pos,
        "out_pos": out_pos,
        "tree_id": tree_id_n,
        "seg_root": seg_first,
        "euler_reset": euler_reset,
        "euler_src": euler_src,
        "euler_is_in": euler_is_in,
        "cut_child_idx": cut_child_idx,
        "cut_child_w": cut_child_w,
        "tree_start": tree_start,
        "adj_start": adj_start,
        "adj_list": adj_list,
        "sub_end": pixels + s_sz,
        "num_trees_actual": is_root.sum(),
        "adj_total": adj_start[tmax],
        "labels": lab,
    }


def check_forest_capacity(raw: dict, tmax: int) -> None:
    """Raise if build_forest_device's static capacities were exceeded.
    Reads two scalars on the host, so it waits for the build."""
    nt = int(raw["num_trees_actual"])
    if nt > tmax:
        raise ValueError(
            f"component count {nt} exceeds tmax={tmax}; rebuild with a larger tree capacity"
        )
    at = int(raw["adj_total"])
    if at > raw["adj_list"].shape[0]:
        raise ValueError(f"inter-tree adjacency {at} exceeds adj_cap={raw['adj_list'].shape[0]}")


def device_forest_arrays(raw: dict, height: int, width: int, tmax: int,
                         check: bool = True) -> ForestArrays:
    """Wrap build_forest_device's dict as ForestArrays (num_trees = tmax).
    check=True verifies the static capacities (check_forest_capacity, a
    host sync). The frame programs check once, where the forest is built
    (models/sgbm_mst.py::_view_forest), and wrap with check=False, so a
    frame that refines on a chained forest enqueues without a sync."""
    if check:
        check_forest_capacity(raw, tmax)
    return ForestArrays(
        **{k: raw[k] for k in ForestArrays._fields if k in raw},
        num_trees=tmax,
        height=height,
        width=width,
    )
