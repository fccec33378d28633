"""The (tile_y, tile_x, dslab) cost-volume pipeline (port of
`stereomatch_tpu/parallel/tiled2d.py`).

The row-tiled pipeline (tiled.py) with two more axes:

  - tile_x, 2-D image tiles: images stay row-split (they are tiny beside
    the volume), and each rank slices its column block and halo from the
    full-width rows, so the corner halos come with the row halo exchange
    over tile_y and need no other transfer;
  - dslab: the (H, W, D) volume split over D. Cost and guided filter are
    slice-local; the WTA is one argmin-combine (dslab.py).

The Huber denoise runs on the (tile_y, tile_x) grid, one boundary row and
one boundary column exchanged per iteration. Tiled equals whole to float
rounding (tests/test_torch_parallel.py holds it).
"""

from __future__ import annotations

import torch

from ..config import CostVolumeConfig, CostVolumePipelineConfig
from ..ops.cost import _grad_x, bgr_to_gray
from ..ops.postprocess import lr_check_fill_pair
from .dslab import wta_disparity_dslab
from .halo import halo_exchange_rows
from .mesh import Mesh, as_input
from .tiled import _denoise_tiled, _guided_volume_block

__all__ = ["make_mesh3", "tiled2d_cost_volume_stereo"]


def make_mesh3(n_ty: int, n_tx: int, n_dslab: int, device: torch.device | str = "cuda") -> Mesh:
    """A (tile_y, tile_x, dslab) mesh (SURVEY §5's mesh without the
    host / frame axis, which multihost.py composes outside)."""
    return Mesh({"tile_y": n_ty, "tile_x": n_tx, "dslab": n_dslab}, device)


def _adgrad_block(left_e, right_e, v: CostVolumeConfig, gx0: int, wext: int, d0: int, ds: int):
    """The AD+gradient volumes of `ops.cost.adgrad_bgr_volumes` for one
    block: the rows of the full-width row-extended BGR bands left_e /
    right_e, the global columns [gx0, gx0 + wext) (gx0 may be negative in
    the halo), the global disparity slices [d0, d0 + ds). Columns read
    outside the image are edge-clamped, as the whole image's shifted
    stacks are; in-image pixels whose match leaves the image get bad_cost
    there too. Returns (lvol, rvol, gray_l, gray_r), the grays full-width."""
    w = left_e.shape[1]
    dev = left_e.device
    gray_l, gray_r = bgr_to_gray(left_e), bgr_to_gray(right_e)
    gl, gr = _grad_x(gray_l), _grad_x(gray_r)
    xs = gx0 + torch.arange(wext, device=dev)  # global columns
    dvals = v.min_disp + d0 + torch.arange(ds, device=dev)  # global disparities
    own = xs.clamp(0, w - 1)

    def volume(ref_bgr, ref_grad, match_bgr, match_grad, sign):
        idx = (xs[:, None] + sign * dvals[None, :]).clamp(0, w - 1)
        color_l1 = torch.sum(torch.abs(ref_bgr[:, own, None, :] - match_bgr[:, idx]), dim=-1)
        grad_l1 = torch.abs(ref_grad[:, own, None] - match_grad[:, idx])
        return v.color_weight * torch.clamp(color_l1 * (1.0 / 3.0), max=v.color_truncation) + \
            v.gradient_weight * torch.clamp(grad_l1, max=v.gradient_truncation)

    bad = torch.full((), v.bad_cost, dtype=torch.float32, device=dev)
    rvol = torch.where((xs[:, None] + dvals[None, :] + 1 < w)[None],
                       volume(right_e, gr, left_e, gl, +1), bad)
    lvol = torch.where(((xs[:, None] - dvals[None, :] >= 0) & (xs[:, None] + 1 < w))[None],
                       volume(left_e, gl, right_e, gr, -1), bad)
    return lvol.float(), rvol.float(), gray_l, gray_r


def _body2d(left, right, cfg: CostVolumePipelineConfig, denoise: bool, halo: int, mesh: Mesh,
            lr_check: bool = False):
    """One frame on this rank's (rows, columns, slab) block; left / right
    are the rank's full-width row tiles (Hs, W, 3). Returns its (Hs, Ws)
    blocks of both maps."""
    v, g = cfg.volume, cfg.guided
    hs, wfull = left.shape[:2]
    n_ty, n_tx, n_dd = (mesh.size(a) for a in ("tile_y", "tile_x", "dslab"))
    iy, ix, idd = (mesh.index(a) for a in ("tile_y", "tile_x", "dslab"))
    ws, ds = wfull // n_tx, v.num_disp // n_dd
    gx0, wext = ix * ws - halo, ws + 2 * halo
    dev = left.device

    left_e = halo_exchange_rows(left, halo, mesh, "tile_y")
    right_e = halo_exchange_rows(right, halo, mesh, "tile_y")
    lvol, rvol, gray_l, gray_r = _adgrad_block(left_e, right_e, v, gx0, wext, idd * ds, ds)

    # block pixels outside the global image cost zero and mask a and b
    # (the whole image's zero padding); the guide is zero there as well
    grow = iy * hs + torch.arange(-halo, hs + halo, device=dev)
    gxs = gx0 + torch.arange(wext, device=dev)
    mask2d = ((grow >= 0) & (grow < n_ty * hs))[:, None] & ((gxs >= 0) & (gxs < wfull))[None, :]
    zero = lvol.new_zeros(())
    lvol = torch.where(mask2d[..., None], lvol, zero)
    rvol = torch.where(mask2d[..., None], rvol, zero)
    cols = gxs.clamp(0, wfull - 1)
    gl_blk = torch.where(mask2d, gray_l[:, cols], zero)
    gr_blk = torch.where(mask2d, gray_r[:, cols], zero)
    inner = (slice(halo, halo + hs), slice(halo, halo + ws))
    lvol = _guided_volume_block(gl_blk, lvol, g.radius, g.eps, g.slab, mask2d)[inner]
    rvol = _guided_volume_block(gr_blk, rvol, g.radius, g.eps, g.slab, mask2d)[inner]
    dl = wta_disparity_dslab(lvol, v.min_disp, mesh)
    dr = wta_disparity_dslab(rvol, v.min_disp, mesh)
    del lvol, rvol

    if denoise:
        dl, dr = _denoise_tiled((dl, dr), (gray_l, gray_r), cfg, halo, mesh, "tile_y", "tile_x")

    if lr_check:
        # the LR check and the directional fill scan whole rows: gather the
        # (small) map rows over tile_x, run the shared row ops
        # (ops.postprocess.lr_check_fill_pair, the whole pipeline's) on
        # every rank, and slice the block back out
        dl_f, dr_f = lr_check_fill_pair(mesh.gather(dl, "tile_x", 1),
                                        mesh.gather(dr, "tile_x", 1), float(v.max_disp),
                                        float(v.min_disp))
        x0 = ix * ws
        dl, dr = dl_f[:, x0:x0 + ws], dr_f[:, x0:x0 + ws]
    return dl, dr


def _check_shape(mesh: Mesh, shape: tuple[int, int], cfg: CostVolumePipelineConfig) -> int:
    h, w = shape
    if h % mesh.size("tile_y") or w % mesh.size("tile_x") or cfg.volume.num_disp % mesh.size(
            "dslab"):
        raise ValueError(f"H {h}, W {w} and D {cfg.volume.num_disp} must divide by the mesh "
                         f"{mesh.shape}")
    return 2 * cfg.guided.radius


def tiled2d_cost_volume_stereo(mesh: Mesh, shape: tuple[int, int],
                               cfg: CostVolumePipelineConfig = CostVolumePipelineConfig(),
                               denoise: bool = True, lr_check: bool = False):
    """The cost-volume pipeline split over a (tile_y, tile_x, dslab) mesh.

    shape: the global (H, W); H must divide by tile_y, W by tile_x and
    cfg.volume.num_disp by dslab. Returns fn(left_bgr, right_bgr) ->
    (left_disp, right_disp): the whole (H, W, 3) float images in, the same
    on every rank; the whole (H, W) maps out on every rank of the mesh
    (None on a rank outside it)."""
    halo = _check_shape(mesh, shape, cfg)

    def fn(left_bgr, right_bgr):
        if not mesh.member:
            return None
        left, right = (mesh.shard(as_input(x, mesh.device), "tile_y")
                       for x in (left_bgr, right_bgr))
        dl, dr = _body2d(left, right, cfg, denoise, halo, mesh, lr_check)
        return tuple(mesh.gather(mesh.gather(d, "tile_x", 1), "tile_y", 0) for d in (dl, dr))

    return fn
