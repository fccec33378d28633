"""Kernel K2, the segmented prefix sum of the 3DMST tree filter
(csrc/seg_scan.cu), and its ancestor-sum entry, each with its plain
PyTorch twin.

K2 replaces `stereomatch_tpu/ops/mst_scan_pallas.py::segmented_cumsum_pallas`
(and the XLA scan `ops/mst.py::_segmented_cumsum_mm` it stands in for).
Both versions here keep the JAX scans' 256-element reassociation: inside
each 256-element block the raw inclusive prefix pf is taken and an element
after the block's last reset r gets pf[j] - pf[r-1]; the segment open at a
block's end carries into the next block. A flat cumsum over millions of
Euler events would not keep the float32 conditioning `tree_filter`
depends on. Kernel and twin sum in different orders inside a block and
across blocks, so they agree to float32 rounding (rtol 1e-5, atol 1e-4,
the JAX package's own bound for its two scans).

K2 is one single-pass launch a call: its tiles pass the open segment on
by a decoupled look-back through a workspace that belongs to the caller's
stream (`_workspace`), is allocated once (and grown) and never cleared
between calls, so a call allocates only its output and never syncs.
"""

from __future__ import annotations

import torch

__all__ = ["SCAN_BLOCK", "segmented_cumsum", "segmented_cumsum_twin", "ancestor_sums",
           "ancestor_sums_twin", "lookback_counts"]

SCAN_BLOCK = 256
_EPOCHS = 1 << 30  # the kernel's epoch field; 0 marks a word as never written


class _Workspace:
    """K2's per-stream state: int64 words (an id counter, two look-back
    counts, the tiles' published words), the tile ids earlier calls took
    and the last call's epoch."""

    def __init__(self, words: int, device: torch.device):
        self.words = torch.zeros(words, dtype=torch.int64, device=device)
        self.base = 0
        self.epoch = 0


_WORKSPACES: dict[tuple[torch.device, int], _Workspace] = {}


def _workspace(device: torch.device, words: int) -> _Workspace:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.words.numel() < words:
        # a fresh zero workspace; the old one is freed in stream order
        ws = _WORKSPACES[key] = _Workspace(
            max(words, 0 if ws is None else 2 * ws.words.numel()), device)
    ws.epoch += 1
    if ws.epoch == _EPOCHS:  # a word of this epoch may be left from 2^30 calls ago
        ws.words.zero_()
        ws.base, ws.epoch = 0, 1
    return ws


def _launch(kernel, k: int, m: int, device: torch.device, *operands) -> None:
    """One K2 launch on the current stream, with that stream's workspace."""
    from .._build import load_kernels

    ext = load_kernels()
    ids, words = ext.seg_scan_plan(k, m)
    ws = _workspace(device, words)
    getattr(ext, kernel)(*operands, ws.words, ws.base, ws.epoch)
    ws.base += ids


def lookback_counts(device: torch.device | str = "cuda") -> tuple[int, int, int]:
    """(tile ids taken, look-backs, look-backs that went past the tile
    before) of the current stream's K2 workspace since it was allocated;
    the look-backs are row 0's of each tile. Reads the device (a sync)."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    ws = _WORKSPACES.get((dev, torch.cuda.current_stream(dev).cuda_stream))
    return (0, 0, 0) if ws is None else tuple(ws.words[:3].tolist())


def _check_mask(name: str, t: torch.Tensor, m: int, device: torch.device) -> torch.Tensor:
    """t as the kernel reads it, a contiguous (m,) uint8 on `device`."""
    if t.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"{name} must be bool or uint8, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the values on {device}")
    if t.shape != (m,):
        raise ValueError(f"{name} must have shape ({m},), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _check_values(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"K2 takes CUDA (or CPU) tensors, got one on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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


def segmented_cumsum(x: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive prefix sum (see module docstring).

    x: (..., M) float32; reset: (M,) bool or uint8, reset[0] true. A CUDA
    tensor launches K2 (raising on anything it does not take); a CPU
    tensor runs the twin. `segmented_cumsum.launches` counts launches."""
    if x.device.type == "cpu":
        return segmented_cumsum_twin(x, reset)
    _check_values("x", x)
    m = x.shape[-1]
    r8 = _check_mask("reset", reset, m, x.device)
    x2 = x.reshape(-1, m)
    out = torch.empty_like(x2)
    _launch("seg_scan", x2.shape[0], m, x.device, x2, r8, out)
    segmented_cumsum.launches += 1
    return out.reshape(x.shape)


segmented_cumsum.launches = 0


def ancestor_sums_twin(v: torch.Tensor, euler_src: torch.Tensor, euler_is_in: torch.Tensor,
                       euler_reset: torch.Tensor, in_pos: torch.Tensor) -> torch.Tensor:
    """Sum over in-segment ancestors-or-self of v (..., N): gather v into
    Euler order, +v at in-events and -v at out-events, scan, read each
    node's in-event."""
    ev = v.index_select(-1, euler_src)
    q = segmented_cumsum_twin(torch.where(euler_is_in, ev, -ev), euler_reset)
    return q.index_select(-1, in_pos)


def ancestor_sums(v: torch.Tensor, euler_src: torch.Tensor, euler_is_in: torch.Tensor,
                  euler_reset: torch.Tensor, in_pos: torch.Tensor) -> torch.Tensor:
    """`ancestor_sums_twin` as one K2 launch for a CUDA tensor: the kernel
    gathers +-v on its loads and stores each in-event's scan at its node
    (in_pos[euler_src[j]] == j at every in-event, so in_pos is not read);
    the (..., 2N) scan never reaches device memory. v: (..., N) float32;
    euler_src (2N,) int64 with every node's one in-event; euler_is_in and
    euler_reset (2N,) bool or uint8. A CPU tensor runs the twin.
    `ancestor_sums.launches` counts launches."""
    if v.device.type == "cpu":
        return ancestor_sums_twin(v, euler_src, euler_is_in, euler_reset, in_pos)
    _check_values("v", v)
    m = euler_src.shape[0]
    if euler_src.dtype != torch.int64 or euler_src.shape != (m,):
        raise TypeError(f"euler_src must be (2N,) int64, got {euler_src.dtype}"
                        f"{list(euler_src.shape)}")
    if euler_src.device != v.device or not euler_src.is_contiguous():
        raise ValueError(f"euler_src must be contiguous on {v.device}")
    is_in = _check_mask("euler_is_in", euler_is_in, m, v.device)
    r8 = _check_mask("euler_reset", euler_reset, m, v.device)
    n = v.shape[-1]
    v2 = v.reshape(-1, n)
    out = torch.empty_like(v2)
    _launch("ancestor_sums", v2.shape[0], m, v.device, v2, euler_src, is_in, r8, out)
    ancestor_sums.launches += 1
    return out.reshape(v.shape)


ancestor_sums.launches = 0
