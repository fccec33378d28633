"""Pure-Python forest construction on a given partition (port of
`forest_from_labels` in `stereomatch_tpu/native/pyforest.py`).

Per-component minimum spanning trees come from Kruskal over ascending
within-component edges, then the same weighted-depth segment splits, DFS
numbering and inter-tree adjacency as treebuild.cpp, in the same Forest
contract. Python-loop speed: tests/test_torch_native.py holds it to the
JAX package's on the same labels.
"""

from __future__ import annotations

import numpy as np


def forest_from_labels(labels: np.ndarray, wr: np.ndarray, wd: np.ndarray,
                       gamma: float, delta: float):
    """Build a Forest from per-pixel component labels + edge weights.

    labels: (H, W) int — any partition; per-component MSTs come from
    Kruskal over ascending-weight within-component edges (the reference's
    per-component Boost MST, src/Stereo3DMST.cpp:434-446, honoring the
    same ascending order)."""
    from . import Forest

    h, w = labels.shape
    n = h * w
    lab = np.asarray(labels).reshape(-1)

    # 4-neighbor edges in raster right+down order (Stereo3DMST.cpp:242-282)
    ys, xs = np.mgrid[0:h, 0 : w - 1]
    a_r = (ys * w + xs).reshape(-1)
    ys, xs = np.mgrid[0 : h - 1, 0:w]
    a_d = (ys * w + xs).reshape(-1)
    ea = np.concatenate([a_r, a_d]).astype(np.int64)
    eb = np.concatenate([a_r + 1, a_d + w]).astype(np.int64)
    ew = np.concatenate(
        [np.asarray(wr, np.float32).reshape(-1), np.asarray(wd, np.float32).reshape(-1)]
    )

    order = np.argsort(ew, kind="stable")
    same = lab[ea] == lab[eb]

    # Kruskal per component (DSU) over ascending weights -> tree edges
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    adj = [[] for _ in range(n)]
    for i in order:
        if not same[i]:
            continue
        a, b = find(ea[i]), find(eb[i])
        if a != b:
            parent[b] = a
            adj[ea[i]].append((int(eb[i]), float(ew[i])))
            adj[eb[i]].append((int(ea[i]), float(ew[i])))

    # tree ids in raster-first-occurrence order (treebuild.cpp:150-162)
    tree_of_lab = {}
    tree_root_pixel = []
    tid_pix = np.empty(n, np.int32)
    for p in range(n):
        t = tree_of_lab.get(lab[p])
        if t is None:
            t = len(tree_root_pixel)
            tree_of_lab[lab[p]] = t
            tree_root_pixel.append(p)
        tid_pix[p] = t
    num_trees = len(tree_root_pixel)

    # phase A: DFS per tree, weighted-depth segment split (treebuild.cpp:164-210)
    parent_pix = np.full(n, -1, np.int64)
    parent_w = np.zeros(n, np.float32)
    gdepth = np.zeros(n, np.float32)
    seg_of_pix = np.full(n, -1, np.int64)
    seg_root_pixel = []
    seg_tree = []
    for t in range(num_trees):
        root = tree_root_pixel[t]
        seg_of_pix[root] = len(seg_root_pixel)
        seg_root_pixel.append(root)
        seg_tree.append(t)
        parent_pix[root] = root
        stack = [root]
        while stack:
            p = stack.pop()
            for q, wgt in adj[p]:
                if q == parent_pix[p] or parent_pix[q] >= 0:
                    continue
                parent_pix[q] = p
                parent_w[q] = wgt
                gd = gdepth[p] + gamma * wgt
                if gd > delta:
                    seg_of_pix[q] = len(seg_root_pixel)
                    seg_root_pixel.append(q)
                    seg_tree.append(t)
                    gdepth[q] = 0.0
                else:
                    seg_of_pix[q] = seg_of_pix[p]
                    gdepth[q] = gd
                stack.append(q)
    num_segments = len(seg_root_pixel)

    # phase B: per-segment DFS -> node order + Euler events (treebuild.cpp:212-254)
    pixel_of_node = np.zeros(n, np.int32)
    node_of_pixel = np.zeros(n, np.int32)
    parent_node = np.zeros(n, np.int32)
    w_exp = np.zeros(n, np.float32)
    rel_gd = np.zeros(n, np.float32)
    in_pos = np.zeros(n, np.int32)
    out_pos = np.zeros(n, np.int32)
    seg_id = np.zeros(n, np.int32)
    tree_id = np.zeros(n, np.int32)
    next_node = 0
    next_euler = 0
    for s in range(num_segments):
        sroot = seg_root_pixel[s]
        dfs = [(sroot, 0)]
        while dfs:
            p, state = dfs.pop()
            if state == 1:
                out_pos[node_of_pixel[p]] = next_euler
                next_euler += 1
                continue
            node = next_node
            next_node += 1
            node_of_pixel[p] = node
            pixel_of_node[node] = p
            in_pos[node] = next_euler
            next_euler += 1
            seg_id[node] = s
            tree_id[node] = seg_tree[s]
            rel_gd[node] = gdepth[p]
            if p == sroot and p == tree_root_pixel[seg_tree[s]]:
                parent_node[node] = node
                w_exp[node] = 0.0
            else:
                parent_node[node] = node_of_pixel[parent_pix[p]]
                w_exp[node] = np.exp(-gamma * parent_w[p])
            dfs.append((p, 1))
            for q, _ in adj[p]:
                if parent_pix[q] == p and q != p and seg_of_pix[q] == s:
                    dfs.append((q, 0))

    tcount = np.bincount(tree_id, minlength=num_trees)
    tree_start = np.zeros(num_trees + 1, np.int32)
    tree_start[1:] = np.cumsum(tcount)

    # inter-tree adjacency from cross-component image edges (treebuild.cpp:264-294)
    ca, cb = tid_pix[ea], tid_pix[eb]
    cross = ca != cb
    lo = np.minimum(ca[cross], cb[cross]).astype(np.int64)
    hi = np.maximum(ca[cross], cb[cross]).astype(np.int64)
    pairs = np.unique(lo * num_trees + hi)
    pa, pb = (pairs // num_trees).astype(np.int32), (pairs % num_trees).astype(np.int32)
    adeg = np.bincount(pa, minlength=num_trees) + np.bincount(pb, minlength=num_trees)
    adj_start = np.zeros(num_trees + 1, np.int32)
    adj_start[1:] = np.cumsum(adeg)
    adj_list = np.zeros(max(int(adj_start[-1]), 1), np.int32)
    fill = adj_start[:-1].astype(np.int64).copy()
    for x, y in zip(pa, pb):
        adj_list[fill[x]] = y
        fill[x] += 1
        adj_list[fill[y]] = x
        fill[y] += 1

    return Forest(
        height=h, width=w,
        pixel_of_node=pixel_of_node, parent_node=parent_node,
        w_exp=w_exp, rel_gd=rel_gd, in_pos=in_pos, out_pos=out_pos,
        seg_id=seg_id, tree_id=tree_id, node_of_pixel=node_of_pixel,
        tree_start=tree_start, adj_start=adj_start,
        adj_list=adj_list[: int(adj_start[-1])],
        num_trees=num_trees, num_segments=num_segments,
    )
