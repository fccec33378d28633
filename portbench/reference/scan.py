# Frozen copy of the plain PyTorch twins of kernel K2 in
# stereomatch_tpu_torch/ops/mst_scan_cuda.py, taken when the benchmark was
# defined, for the benchmark's reference. Do not edit.
"""The segmented prefix sum of the 3DMST tree filter and its ancestor sum,
in plain PyTorch: 256-element blocks, the raw block prefix as a product
with a triangular matrix of ones, the carries in an associative-scan order."""

from __future__ import annotations

import torch

__all__ = ['SCAN_BLOCK', 'segmented_cumsum_twin', 'ancestor_sums_twin', 'segmented_cumsum', 'ancestor_sums']


SCAN_BLOCK = 256


def _carry_scan(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented scan of (value, has-reset) pairs along the last
    axis, in jax.lax.associative_scan's order of adds (combine adjacent
    pairs, scan those, fill in the even positions), so that the carries
    round as the JAX package's do."""
    n = v.shape[-1]
    if n < 2:
        return v

    def comb(av, af, bv, bf):
        return torch.where(bf, bv, av + bv), af | bf

    ov = _carry_scan(*comb(v[..., 0:-1:2], f[..., 0:-1:2], v[..., 1::2], f[..., 1::2]))
    of = torch.cumsum((f[..., 0:-1:2] | f[..., 1::2]).int(), dim=-1) > 0  # the pairs' or-scan
    lo = slice(None, -1) if n % 2 == 0 else slice(None)
    ev, _ = comb(ov[..., lo], of[..., lo], v[..., 2::2], f[..., 2::2])
    out = torch.empty_like(v)
    out[..., 0::2] = torch.cat([v[..., :1], ev], dim=-1)
    out[..., 1::2] = ov
    return out


def segmented_cumsum_twin(x: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of x (..., M) float32 along the last axis,
    restarting where reset (M,) is true; blocked as described above, with
    the adds of the JAX package's `_segmented_cumsum_mm`: the raw block
    prefix as a product with a triangular matrix of ones (a float32 sum in
    index order, where torch.cumsum on the CPU adds in float64) and the
    carries in jax.lax.associative_scan's order. Where a segment's depth
    range is large the sums cancel, and then any other order of adds
    lands far from JAX's."""
    m = x.shape[-1]
    lead = x.shape[:-1]
    b = SCAN_BLOCK
    nb = -(-m // b)
    pad = nb * b - m
    xb = torch.nn.functional.pad(x.reshape(-1, m), (0, pad)).reshape(-1, nb, b)
    rb = torch.nn.functional.pad(reset.bool(), (0, pad), value=True).reshape(nb, b)
    pf = xb @ torch.ones(b, b, dtype=x.dtype, device=x.device).triu()
    t = torch.arange(b, device=x.device)
    lr = torch.cummax(torch.where(rb, t, -1), dim=-1).values  # last reset <= t
    base = torch.gather(pf, -1, (lr - 1).clamp(min=0).expand_as(pf))
    loc = torch.where(lr >= 1, pf - base, pf)
    # carry into each block: exclusive segmented scan of the blocks'
    # (open-segment sum, has-reset) pairs
    v = loc[..., -1]
    carry = torch.nn.functional.pad(_carry_scan(v, (lr[:, -1] >= 0).expand_as(v))[..., :-1],
                                    (1, 0))
    out = loc + torch.where(lr < 0, carry[..., None], loc.new_zeros(()))
    return out.reshape(-1, nb * b)[:, :m].reshape(lead + (m,))


def ancestor_sums_twin(v: torch.Tensor, euler_src: torch.Tensor, euler_is_in: torch.Tensor,
                       euler_reset: torch.Tensor, in_pos: torch.Tensor) -> torch.Tensor:
    """Sum over in-segment ancestors-or-self of v (..., N): gather v into
    Euler order, +v at in-events and -v at out-events, scan, read each
    node's in-event."""
    ev = v.index_select(-1, euler_src)
    q = segmented_cumsum_twin(torch.where(euler_is_in, ev, -ev), euler_reset)
    return q.index_select(-1, in_pos)


segmented_cumsum = segmented_cumsum_twin
ancestor_sums = ancestor_sums_twin
