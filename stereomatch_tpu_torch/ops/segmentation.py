"""Parallel graph segmentation by Boruvka rounds (port of
`stereomatch_tpu/ops/segmentation.py`).

Felzenszwalb's adaptive threshold thr(C) = w_internal_max(C) + c/|C| and
the min-size merge, evaluated per round for every component at once:
each root picks its minimum outgoing edge by (weight, edge id) rank with
one scatter-min, hooks to a smaller root, and pointer jumping compresses.
Integer results equal the JAX module's exactly. Indices are int64; the
JAX module's float32-packed gathers are not needed here.

Loops that JAX runs to a fixpoint with `lax.while_loop` are Python loops
with a hard cap here, checked on the host once per round; reaching the cap
raises, since the JAX loops have none to fall back on.
"""

from __future__ import annotations

import math

import torch

__all__ = ["boruvka_segment", "segment_image"]

_BIG_RANK = 2**30


def ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def _at_ea(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """x[ea] for the grid edge list, as two slices of the (h, w) view."""
    x2 = x.reshape((h, w) + x.shape[1:])
    flat = (-1,) + tuple(x.shape[1:])
    return torch.cat([x2[:, :-1].reshape(flat), x2[:-1, :].reshape(flat)])


def _at_eb(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """x[eb]: b-endpoints are x+1 for right edges, y+1 for down edges."""
    x2 = x.reshape((h, w) + x.shape[1:])
    flat = (-1,) + tuple(x.shape[1:])
    return torch.cat([x2[:, 1:].reshape(flat), x2[1:, :].reshape(flat)])


def _edge_rank_tables(ew: torch.Tensor):
    """(rank, eid_by_rank) for (weight, edge id) order: a stable sort of
    the weights breaks ties by edge id."""
    eid_by_rank = torch.sort(ew, stable=True).indices
    rank = torch.empty_like(eid_by_rank)
    rank[eid_by_rank] = torch.arange(ew.shape[0], device=ew.device)
    return rank, eid_by_rank


def _pointer_jump_conv(parent: torch.Tensor) -> torch.Tensor:
    """Pointer jumping to its fixpoint (p[p] == p everywhere). Doubling
    reaches it within ceil(log2 N) + 1 rounds."""
    cap = ceil_log2(parent.shape[0]) + 1
    p = parent
    for _ in range(cap):
        p2 = p[p]
        if torch.equal(p2, p):
            return p2
        p = p2
    raise RuntimeError(f"pointer jumping did not converge in {cap} rounds")


def _min_rank_at_roots(n: int, ra, rb, rv) -> torch.Tensor:
    """Per-root minimum of rv over edges incident at either endpoint root."""
    best = torch.full((n,), _BIG_RANK, dtype=rv.dtype, device=rv.device)
    return best.scatter_reduce(0, torch.cat([ra, rb]), torch.cat([rv, rv]), "amin")


def boruvka_segment(
    wr: torch.Tensor,
    wd: torch.Tensor,
    c: float = 5000.0,
    min_size: int = 200,
    rounds: int = 12,
    merge_rounds: int = 6,
    rank_tables=None,
) -> torch.Tensor:
    """Segment the image graph; returns (H, W) int64 component labels
    (= the component's minimum flat pixel index). wr: (H, W-1) right-edge
    weights, wd: (H-1, W) down-edge weights. `rounds` / `merge_rounds`
    bound the threshold phase and the min-size merge phase (the JAX
    schedule); each phase also stops after a round without hooks."""
    h = wr.shape[0]
    w = wd.shape[1]
    n = h * w
    dev = wr.device
    # grid edge weights: right edges row-major, then down edges (the
    # endpoints are read as slices by _at_ea / _at_eb)
    ew = torch.cat([wr.reshape(-1), wd.reshape(-1)]).float()
    e = ew.shape[0]
    rank, eid_by_rank = _edge_rank_tables(ew) if rank_tables is None else rank_tables
    me = torch.arange(n, device=dev)
    c32 = torch.tensor(c, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    big = torch.full((), _BIG_RANK, dtype=rank.dtype, device=dev)

    def do_round(parent, size, wint, gate: bool):
        aux = wint + c32 / size.clamp(min=1).float() if gate else size.float()
        aux_p = aux[parent]
        ra, rb = _at_ea(parent, h, w), _at_eb(parent, h, w)
        ga, gb = _at_ea(aux_p, h, w), _at_eb(aux_p, h, w)
        cross = ra != rb
        if gate:
            ok = cross & (ew <= ga) & (ew <= gb)
        else:
            ok = cross & ((ga < float(min_size)) | (gb < float(min_size)))
        best_r = _min_rank_at_roots(n, ra, rb, torch.where(ok, rank, big))
        has = best_r < _BIG_RANK
        be = eid_by_rank[best_r.clamp(0, e - 1)]
        ra_e, rb_e, bw = ra[be], rb[be], ew[be]
        other = torch.where(ra_e == me, rb_e, ra_e)
        # hook roots to a smaller chosen neighbour root (acyclic)
        is_root = parent == me
        hooked = has & (other < me) & is_root
        p = torch.where(is_root, torch.where(hooked, other, me), parent)
        p = _pointer_jump_conv(p)
        new_size = torch.bincount(p, minlength=n)
        contrib = torch.where(
            is_root, torch.maximum(wint, torch.where(hooked, bw, zero)), zero
        )
        new_wint = torch.zeros(n, dtype=torch.float32, device=dev).scatter_reduce(
            0, p, contrib, "amax"
        )
        return p, new_size, new_wint, bool(hooked.any())

    parent, size, wint = me, torch.ones(n, dtype=torch.int64, device=dev), torch.zeros(n, device=dev)
    for gate, max_rounds in ((True, rounds), (False, merge_rounds)):
        for _ in range(max_rounds):
            parent, size, wint, hooked_any = do_round(parent, size, wint, gate)
            if not hooked_any:
                break
    return parent.reshape(h, w)


def channel_l1(d: torch.Tensor) -> torch.Tensor:
    """sum(|d|, -1) as a left fold over channels (the XLA reduce order), so
    integer-valued colour differences give bitwise the JAX edge weights."""
    d = torch.abs(d)
    s = d[..., 0]
    for i in range(1, d.shape[-1]):
        s = s + d[..., i]
    return s


def segment_image(bgr, c: float = 5000.0, min_size: int = 200,
                  device: torch.device | str = "cuda", **kw) -> torch.Tensor:
    """L1 colour edge weights (ref diff(), Stereo3DMST.cpp:83-94) of an
    (H, W, 3) image on `device`, then boruvka_segment."""
    img = torch.as_tensor(bgr, dtype=torch.float32, device=device)
    wr = channel_l1(img[:, 1:] - img[:, :-1])
    wd = channel_l1(img[1:] - img[:-1])
    return boruvka_segment(wr, wd, c, min_size, **kw)
