"""3DMST over a mesh: candidate batches split over ranks (port of
`stereomatch_tpu/parallel/mst_mesh.py`).

The reference parallelizes MST_PMS with OpenMP over trees
(src/Stereo3DMST.cpp:559). Here the split axis is the CANDIDATE batch:
each iteration scores K = max_neighbors + n_refine label proposals with
full-forest tree filters (kernels K2 and K2a on the card), so the rank at
index i along "cand" scores the candidates j = i (mod n), and the winner a
pixel keeps is one argmin-combine (MIN of the cost, MIN of j among the
ties, SUM of the winning planes, the pattern of dslab.py). The label state
stays replicated, so iterations chain with no other transfer.

Candidates are drawn by their global index j (`ops.mst.make_candidate_fn`)
and ties go to the smallest j, here and in `ops.mst.mst_pms_optimize`: the
mesh gives its result up to the float rounding of tree filters batched
differently, which can flip near-exact ties on a small share of pixels.
On one rank the batches are the same ones.

`normalize_aggregation` is applied in both variants, as in the one-card
optimizer. The JAX package's candidate-split body does not apply it
(`stereomatch_tpu/parallel/mst_mesh.py:59-133`), against the promise of
its docstring; the port does not copy that.

`mst_pms_optimize_mesh_sharded` also splits the cost volume: each rank
along "node" holds the node-order rows of its node block, scores its
nodes' label costs from them, and one all-gather over "node" assembles the
(k, N) costs the tree filter reads.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import random as trandom
from ..config import MSTConfig
from ..ops.mst import (
    ForestArrays,
    aggregation_norm_inv,
    init_labels,
    label_cost,
    make_candidate_fn,
    refine_deltas,
    tree_filter,
)
from .mesh import Mesh

__all__ = [
    "mst_pms_optimize_mesh",
    "make_cand_mesh",
    "make_cand_node_mesh",
    "volume_in_node_order",
    "mst_pms_optimize_mesh_sharded",
]


def make_cand_mesh(n_ranks: int, device: torch.device | str = "cuda") -> Mesh:
    """A 1-D mesh over the candidate axis."""
    return Mesh({"cand": n_ranks}, device)


def make_cand_node_mesh(n_cand: int, n_node: int, device: torch.device | str = "cuda") -> Mesh:
    """A (cand, node) mesh: candidates split over "cand", the cost volume
    and the label-cost gathers over "node"."""
    return Mesh({"cand": n_cand, "node": n_node}, device)


def volume_in_node_order(cost_vol: torch.Tensor, f: ForestArrays) -> torch.Tensor:
    """An (H, W, D) cost volume as (N, D) rows in NODE order (row p: node
    p's pixel), the layout in which a contiguous node block's label costs
    read only its own rows."""
    return cost_vol.reshape(-1, cost_vol.shape[-1])[f.pixel_of_node.to(cost_vol.device)]


def _label_cost_node_block(vol_rows, a, b, c, pix, width: int, max_disp: int) -> torch.Tensor:
    """`ops.mst.label_cost` for a contiguous node block whose node-order
    volume rows are local: vol_rows (Nloc, D), a / b / c (..., Nloc), pix
    the block's pixels (Nloc,)."""
    x = (pix % width).float()
    y = torch.div(pix, width, rounding_mode="floor").float()
    d = x * a + y * b + c
    if max_disp < 2:
        return torch.full(d.shape, 0.5, dtype=torch.float32, device=d.device)
    d_floor = torch.floor(d)
    lo = d_floor.long()
    in_range = (lo >= 0) & (lo + 1 < max_disp)
    nd = vol_rows.shape[-1]
    idx = torch.arange(vol_rows.shape[0], device=d.device) * nd + torch.clamp(lo, 0, max_disp - 2)
    vol_flat = vol_rows.reshape(-1)
    c_lo, c_hi = vol_flat[idx].float(), vol_flat[idx + 1].float()
    frac = d - d_floor
    return torch.where(in_range, (1.0 - frac) * c_lo + frac * c_hi, d.new_full((), 0.5))


def _optimize(key, f: ForestArrays, cfg: MSTConfig, max_neighbors: int, iterations: int,
              init_state, refine_start, mesh: Mesh, costs):
    """The iterations of `ops.mst.mst_pms_optimize` with the candidates
    split over "cand". `costs(pa, pb, pc)` gives the (k, N) node costs of
    this rank's candidates' per-tree planes (k, tmax)."""
    n_cand, i = mesh.size("cand"), mesh.index("cand")
    dev = mesh.device
    deltas_d, deltas_n = refine_deltas(cfg.max_disp, refine_start, dev)
    k_total = max_neighbors + int(deltas_d.shape[0])
    if n_cand > k_total:
        raise ValueError(f"{n_cand} candidate ranks for {k_total} candidates an iteration")
    local_js = list(range(i, k_total, n_cand))
    inv_norm = aggregation_norm_inv(f, cfg.carry_iters) if cfg.normalize_aggregation else None

    key, k0 = trandom.split(key)
    if init_state is None:
        a, b, c = init_labels(k0, f, cfg.max_disp)
        mc = torch.full(a.shape, float("inf"), dtype=torch.float32, device=dev)
    else:
        a, b, c, mc = (torch.as_tensor(x, device=dev) for x in init_state)

    for key_i in trandom.split(key, iterations):
        cand = make_candidate_fn(key_i, a, b, c, f, cfg.max_disp, max_neighbors, deltas_d,
                                 deltas_n)
        params = [cand(j) for j in local_js]
        pa, pb, pc = (torch.stack([p[t] for p in params]) for t in range(3))
        agg = tree_filter(costs(pa, pb, pc), f, cfg.carry_iters)
        if inv_norm is not None:
            agg = agg * inv_norm
        lc, lt = agg.amin(0), torch.argmin(agg, 0)  # ties to the smallest local (and global) j
        lj = lt * n_cand + i

        # argmin-combine over the mesh, ties to the smallest global j, as
        # the one-card argmin over the ordered candidates
        gmin = mesh.all_reduce(lc, "cand", dist.ReduceOp.MIN)
        winner = lc == gmin
        gj = mesh.all_reduce(torch.where(winner, lj, torch.full_like(lj, k_total)), "cand",
                             dist.ReduceOp.MIN)
        mask = winner & (lj == gj)  # on exactly one rank a pixel
        zero = agg.new_zeros(())
        planes = mesh.all_reduce(torch.stack([torch.where(mask, p[lt, f.tree_id], zero)
                                              for p in (pa, pb, pc)]), "cand").unbind(0)
        better = gmin < mc
        a, b, c = (torch.where(better, p, old) for p, old in zip(planes, (a, b, c)))
        mc = torch.where(better, gmin, mc)
    return a, b, c, mc


def mst_pms_optimize_mesh(key: torch.Tensor, cost_vol: torch.Tensor, f: ForestArrays, mesh: Mesh,
                          cfg: MSTConfig = MSTConfig(), max_neighbors: int = 8,
                          iterations: int | None = None, init_state=None,
                          refine_start: float | None = None):
    """`ops.mst.mst_pms_optimize` (the same arguments and result, but
    candidate_chunk) with each iteration's candidates split over the mesh's
    "cand" axis. Inputs are the same on every rank, on the mesh's device;
    the label state (a, b, c, min_cost) comes out the same on every rank
    (None on a rank outside the mesh). refine_start truncates the annealed
    ladder for SGBM-seeded runs, as on one card."""
    if not mesh.member:
        return None
    iters = cfg.iterations if iterations is None else iterations
    # node-order rows: every iteration's lerp reads consecutive rows
    vol = cost_vol.to(getattr(torch, cfg.volume_dtype)).reshape(-1, cost_vol.shape[-1])[
        f.pixel_of_node]

    def costs(pa, pb, pc):
        return label_cost(vol, pa[:, f.tree_id], pb[:, f.tree_id], pc[:, f.tree_id], f,
                          cfg.max_disp, vol_in_node_order=True)

    return _optimize(key, f, cfg, max_neighbors, iters, init_state, refine_start, mesh, costs)


def mst_pms_optimize_mesh_sharded(key: torch.Tensor, vol_node: torch.Tensor, f: ForestArrays,
                                  mesh: Mesh, cfg: MSTConfig = MSTConfig(),
                                  max_neighbors: int = 8, iterations: int | None = None,
                                  init_state=None, refine_start: float | None = None):
    """The memory-split variant on a (cand, node) mesh. vol_node is the
    node-order volume (`volume_in_node_order`), the same on every rank and
    on any device: each rank takes only its block of N / n_node rows to the
    mesh's device, so the cost volume, the largest tensor (3.2 GB float32
    at 2048x1536x256), is split over "node". Its label costs are scored
    there, one all-gather over "node" assembles the (k, N) costs for the
    tree filter, and candidates split over "cand" as in
    `mst_pms_optimize_mesh`. Returns (a, b, c, min_cost), the same on every
    rank of the mesh (None outside it)."""
    if not mesh.member:
        return None
    iters = cfg.iterations if iterations is None else iterations
    n = f.pixel_of_node.shape[0]
    n_node = mesh.size("node")
    if n % n_node:
        raise ValueError(f"{n} nodes do not split over {n_node} node ranks")
    rows = mesh.shard(vol_node, "node").to(mesh.device, getattr(torch, cfg.volume_dtype))
    pix = mesh.shard(f.pixel_of_node, "node")
    tid = mesh.shard(f.tree_id, "node")

    def costs(pa, pb, pc):
        c_loc = _label_cost_node_block(rows, pa[:, tid], pb[:, tid], pc[:, tid], pix, f.width,
                                       cfg.max_disp)
        return mesh.gather(c_loc, "node", 1)

    out = _optimize(key, f, cfg, max_neighbors, iters, init_state, refine_start, mesh, costs)
    # the states agree on every "node" rank (they flow from the gathered
    # costs); one MIN over "node" is the JAX body's replication proof
    return tuple(mesh.all_reduce(x, "node", dist.ReduceOp.MIN) for x in out)
