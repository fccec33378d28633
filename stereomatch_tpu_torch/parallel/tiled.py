"""Row-tiled cost-volume pipeline over a mesh (port of
`stereomatch_tpu/parallel/tiled.py`).

`models.costvolume.cost_volume_stereo` split by image rows over the
mesh's "tile" axis:

  - the AD+gradient cost is purely horizontal, so each tile computes its
    own rows plus a recomputed halo band: the halo is exchanged at the
    IMAGE level (2 radius rows of pixels) and the band's cost recomputed;
  - the guided filter consumes the halo band and crops it off, with the
    global edges' zero padding reproduced by a row mask;
  - WTA is per pixel;
  - the Huber denoise exchanges one boundary row per primal-dual iteration
    (u down, the dual py up).

`tiled_cost_volume_batch` adds the "frame" axis: stereo pairs in data
parallel, rows tiled within each frame group. Tiled equals whole to float
rounding (tests/test_torch_parallel.py holds it).
"""

from __future__ import annotations

import torch

from ..config import CostVolumePipelineConfig, DenoiseConfig
from ..ops.cost import adgrad_bgr_volumes, bgr_to_gray
from ..ops.filters import box_filter
from ..ops.select import wta_disparity
from .halo import halo_exchange_rows
from .mesh import Mesh, as_input

__all__ = ["tiled_cost_volume_stereo", "tiled_cost_volume_batch"]


def _guided_volume_block(gray, vol, radius: int, eps: float, slab: int, mask=None):
    """The guided filter of `ops.filters.guided_filter_volume` (zero
    padding) on an extended block. `mask` marks the rows (1-D) or pixels
    (2-D, tiled2d's column halos) inside the GLOBAL image: a and b are
    zeroed beyond the global edge before their own box filter, as the
    whole image's zero padding has them there (halo pixels past the edge
    would otherwise add a and b built from partial windows)."""
    mean_g = box_filter(gray, radius)
    var_g = box_filter(gray * gray, radius) - mean_g * mean_g
    denom = (var_g + eps)[..., None]
    mg, g3 = mean_g[..., None], gray[..., None]
    if mask is not None:
        mask = (mask[:, None, None] if mask.ndim == 1 else mask[..., None]).to(vol.dtype)
    out = torch.empty_like(vol)
    for s0 in range(0, vol.shape[2], slab):
        p = vol[:, :, s0:s0 + slab]
        mean_p = box_filter(p, radius)
        a = (box_filter(g3 * p, radius) - mg * mean_p) / denom
        b = mean_p - a * mg
        if mask is not None:
            a, b = a * mask, b * mask
        out[:, :, s0:s0 + slab] = box_filter(a, radius) * g3 + box_filter(b, radius)
    return out


def _last_masks(mesh: Mesh, shape, ay: str, ax: str | None, device):
    """Masks of a (Hs, Ws) block's global last row (Hs, 1) and global last
    column (1, Ws): the block's last row on the last rank along `ay`, its
    last column on the last rank along `ax` (or always, when `ax` is None
    and the block holds whole rows)."""
    hs, ws = shape
    last_y = torch.zeros((hs, 1), dtype=torch.bool, device=device)
    last_y[-1] = mesh.index(ay) == mesh.size(ay) - 1
    last_x = torch.zeros((1, ws), dtype=torch.bool, device=device)
    last_x[0, -1] = ax is None or mesh.index(ax) == mesh.size(ax) - 1
    return last_y, last_x


def _huber_denoise_tiled(f, weight, cfg: DenoiseConfig, mesh: Mesh, ay: str,
                         ax: str | None = None):
    """Weighted-Huber primal-dual on this rank's tile of a grid split over
    rows along `ay` (and over columns along `ax`; None: the block holds
    whole rows), exchanging one boundary row (and one boundary column) each
    way per iteration: the 5-point stencil needs no corner. The math of
    `ops.variational.huber_denoise`: forward differences zero at the global
    last row and column, the divergence's boundary rule through zeroed
    last-row and last-column duals."""
    last_y, last_x = _last_masks(mesh, f.shape, ay, ax, f.device)
    zero, zcol = f.new_zeros(()), f.new_zeros((f.shape[0], 1))
    u, q, px, py = f, torch.zeros_like(f), torch.zeros_like(f), torch.zeros_like(f)
    for _ in range(cfg.iterations):
        u_below = mesh.shift(u[:1], ay, -1)  # the next tile's first row
        u_right = zcol if ax is None else mesh.shift(u[:, :1], ax, -1)
        dy = torch.where(last_y, zero, torch.cat([u[1:], u_below]) - u)
        dx = torch.where(last_x, zero, torch.cat([u[:, 1:], u_right], 1) - u)
        q = (q + cfg.sigma * (u - f)) / (1.0 + cfg.sigma * cfg.gamma)
        q = q / torch.clamp(torch.abs(q) / cfg.lam, min=1.0)
        px = (px + cfg.sigma * dx) / (1.0 + cfg.sigma * cfg.delta)
        py = (py + cfg.sigma * dy) / (1.0 + cfg.sigma * cfg.delta)
        norm = torch.clamp(torch.sqrt(px * px + py * py) / weight, min=1.0)
        px, py = px / norm, py / norm
        px_eff = torch.where(last_x, zero, px)
        py_eff = torch.where(last_y, zero, py)
        px_prev = zcol if ax is None else mesh.shift(px_eff[:, -1:], ax, +1)
        py_prev = mesh.shift(py_eff[-1:], ay, +1)  # the previous tile's last row
        div_x = px_eff - torch.cat([px_prev, px_eff[:, :-1]], 1)
        div_y = py_eff - torch.cat([py_prev, py_eff[:-1]])
        u = u + 2.0 * cfg.tau * (div_x + div_y - cfg.lam * q)
    return u


def _denoise_tiled(maps, grays, cfg: CostVolumePipelineConfig, halo: int, mesh: Mesh, ay: str,
                   ax: str | None = None):
    """`ops.variational.variational_disparity_denoise` of this rank's
    (Hs, Ws) blocks of both views' maps, with `ops.variational.edge_weight`
    from their full-width row-extended grays (Hs + 2 halo, W): forward
    differences zero at the GLOBAL last row and column, a block's last row
    reading the true halo row below it."""
    v, dn = cfg.volume, cfg.denoise
    hs, ws = maps[0].shape
    x0 = 0 if ax is None else mesh.index(ax) * ws
    last_y, last_x = _last_masks(mesh, (hs, ws), ay, ax, maps[0].device)
    span = float(v.max_disp - v.min_disp)
    out = []
    for d, gray in zip(maps, grays):
        gsc = gray * (1.0 / 255.0)
        gp = torch.cat([gsc, gsc[:, -1:]], 1)
        blk = gp[halo:halo + hs, x0:x0 + ws]
        zero = blk.new_zeros(())
        dx = torch.where(last_x, zero, gp[halo:halo + hs, x0 + 1:x0 + ws + 1] - blk)
        dy = torch.where(last_y, zero, gp[halo + 1:halo + hs + 1, x0:x0 + ws] - blk)
        weight = torch.exp(-dn.alpha * torch.abs(torch.sqrt(dx * dx + dy * dy)) ** dn.beta)
        u = _huber_denoise_tiled((d - float(v.min_disp)) / span, weight, dn, mesh, ay, ax)
        out.append(u * span + float(v.min_disp))
    return out


def _single_frame_body(left, right, cfg: CostVolumePipelineConfig, denoise: bool, halo: int,
                       mesh: Mesh, axis: str = "tile"):
    """One frame's pipeline on this rank's row tile (Hs, W, 3)."""
    v, g = cfg.volume, cfg.guided
    hs = left.shape[0]
    n, k = mesh.size(axis), mesh.index(axis)

    # the image-level halo, then the band's cost recomputed
    left_e = halo_exchange_rows(left, halo, mesh, axis)
    right_e = halo_exchange_rows(right, halo, mesh, axis)
    gray_l, gray_r = bgr_to_gray(left_e), bgr_to_gray(right_e)
    lvol, rvol = adgrad_bgr_volumes(left_e, right_e, v)

    # rows past the global edge cost ZERO (the whole image's zero padding),
    # not the cost of zero-valued pixels
    grow = k * hs + torch.arange(-halo, hs + halo, device=left.device)
    inb = (grow >= 0) & (grow < n * hs)
    zero = lvol.new_zeros(())
    lvol = torch.where(inb[:, None, None], lvol, zero)
    rvol = torch.where(inb[:, None, None], rvol, zero)
    lvol = _guided_volume_block(gray_l, lvol, g.radius, g.eps, g.slab, inb)[halo:halo + hs]
    rvol = _guided_volume_block(gray_r, rvol, g.radius, g.eps, g.slab, inb)[halo:halo + hs]
    dl = wta_disparity(lvol, v.min_disp)
    dr = wta_disparity(rvol, v.min_disp)
    del lvol, rvol

    if denoise:
        dl, dr = _denoise_tiled((dl, dr), (gray_l, gray_r), cfg, halo, mesh, axis)
    return dl, dr


def tiled_cost_volume_stereo(mesh: Mesh, cfg: CostVolumePipelineConfig = CostVolumePipelineConfig(),
                             denoise: bool = True):
    """The cost-volume pipeline with rows split over the mesh's "tile" axis.

    Returns fn(left_bgr, right_bgr) -> (left_disp, right_disp): the whole
    (H, W, 3) float images in, the same on every rank, H divisible by the
    tile axis; the whole (H, W) float32 maps out on every rank of the mesh,
    on its device (None on a rank outside the mesh)."""
    halo = 2 * cfg.guided.radius

    def fn(left_bgr, right_bgr):
        if not mesh.member:
            return None
        left, right = (mesh.shard(as_input(x, mesh.device), "tile") for x in (left_bgr, right_bgr))
        dl, dr = _single_frame_body(left, right, cfg, denoise, halo, mesh)
        return mesh.gather(dl, "tile"), mesh.gather(dr, "tile")

    return fn


def tiled_cost_volume_batch(mesh: Mesh, cfg: CostVolumePipelineConfig = CostVolumePipelineConfig(),
                            denoise: bool = True):
    """The batched variant: (B, H, W, 3) pairs, frames split over the
    mesh's "frame" axis (B divisible by it; the streaming-video config) and
    rows over "tile" within each frame group. Returns the (B, H, W) maps
    of both views on every rank of the mesh."""
    halo = 2 * cfg.guided.radius

    def fn(left_batch, right_batch):
        if not mesh.member:
            return None
        lb, rb = (mesh.shard(mesh.shard(as_input(x, mesh.device), "frame", 0), "tile", 1)
                  for x in (left_batch, right_batch))
        outs = [_single_frame_body(l, r, cfg, denoise, halo, mesh) for l, r in zip(lb, rb)]
        return tuple(
            mesh.gather(mesh.gather(torch.stack([o[i] for o in outs]), "tile", 1), "frame", 0)
            for i in (0, 1))

    return fn
