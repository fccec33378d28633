"""The port's video path at the ground-truth sizes (the long tests of
tests/test_torch_video.py, apart so that the two files run in parallel):
the reuse_forest keyframe and reset(), the offline video composition's
absolute ground-truth gates, and the scene-cut replay."""

import numpy as np
import torch

from stereomatch_tpu.config import MSTConfig, production_mst_config
from stereomatch_tpu.eval import disparity_metrics
from stereomatch_tpu.synthetic import render_scene, render_sequence, scene_eval_mask
from stereomatch_tpu_torch.serving import compile_mst_video_server
from test_torch_config import port_cfg

# the served-sequence tests of tests/test_serving.py
GH, GW, GD = 120, 160, 24
GCFG = port_cfg(production_mst_config(GD, on_tpu=False, min_cc_size=100, c=2000.0,
                                      forest_backend="device"))
GKW = dict(cfg=GCFG, fine_iterations=4, temporal_iterations=2, temporal_refine_start=4.0,
           device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def test_reuse_forest_keyframe_and_reset():
    """The reuse_forest keyframe equals the rebuild server's (same math,
    same key); temporal frames build no forest and check no capacity (no
    host sync); reset() drops the chained forest."""
    from stereomatch_tpu_torch.models import sgbm_mst

    seq = render_sequence(2, 2, GH, GW, GD, drift=2.0)
    srv = compile_mst_video_server(GH, GW, reuse_forest=True, **GKW)
    base = compile_mst_video_server(GH, GW, **GKW)
    checks = []
    orig = sgbm_mst.check_forest_capacity
    sgbm_mst.check_forest_capacity = lambda raw, tmax: checks.append(tmax) or orig(raw, tmax)
    try:
        t0 = srv.submit_pair(seq[0].left, seq[0].right)
        assert len(checks) == 2 and srv._prev_forest is not None
        fl = srv._prev_forest[0]
        srv.submit_pair(seq[1].left, seq[1].right)
        assert len(checks) == 2 and srv._prev_forest[0] is fl
    finally:
        sgbm_mst.check_forest_capacity = orig
    dl, _ = srv.collect(t0)
    bl, _ = base.collect(base.submit_pair(seq[0].left, seq[0].right))
    assert np.mean(np.abs(dl - bl) > 0.5) < 0.01
    srv.drain()
    srv.reset()
    assert srv._prev_forest is None and srv._prev is None


def test_sgbm_mst_video_absolute_gt_sequence():
    """tests/test_mst_video.py's offline recipe and gates on the device
    forest: keyframe EPE < 1.2, temporal EPE < 1.5, bad2 < 8%, valid > 0.35."""
    from stereomatch_tpu_torch.config import CostVolumeConfig
    from stereomatch_tpu_torch.models.sgbm_mst import sgbm_mst_video
    from stereomatch_tpu_torch.ops.cost import adgrad_bgr_volumes

    h, w, d = 240, 320, 32
    seq = render_sequence(2, 3, h, w, d, drift=3.0)
    vols = []
    for sc in seq:
        lv, rv = adgrad_bgr_volumes(_t(sc.left), _t(sc.right),
                                    CostVolumeConfig(min_disp=0, max_disp=d - 1))
        s = 0.5 / max(lv.max(), rv.max())
        vols.append((lv * s, rv * s))
    cfg = MSTConfig(max_disp=d, iterations=30, min_cc_size=100, c=2000.0,
                    forest_backend="device")
    outs = sgbm_mst_video([(sc.left, sc.right) for sc in seq], vols, port_cfg(cfg),
                          fine_iterations=4, temporal_iterations=2, refine_start=4.0,
                          device="cpu")
    for i, (sc, out) in enumerate(zip(seq, outs)):
        valid = out.left_valid.numpy() & scene_eval_mask(sc)
        assert valid.mean() > 0.35, (i, valid.mean())
        mm = disparity_metrics(out.left_disp.numpy(), sc.disp_left, valid)
        assert mm["epe"] < (1.2 if i == 0 else 1.5) and mm["bad2"] < 0.08, (i, mm)


def test_scene_cut_detection():
    """A hard cut (the mirrored scene) fires exactly one scene cut; the
    replayed frame equals a fresh keyframe with the frame's own key; a
    smooth drift after reset() fires none."""
    sc_a = render_scene(2, GH, GW, GD)
    cut_l, cut_r = sc_a.left[:, ::-1].copy(), sc_a.right[:, ::-1].copy()
    kw = dict(GKW, reuse_forest=True)
    srv = compile_mst_video_server(GH, GW, scene_cut_ratio=0.6, **kw)
    t0 = srv.submit_pair(sc_a.left, sc_a.right, seed=0)
    t1 = srv.submit_pair(cut_l, cut_r, seed=1)
    srv.collect(t0)
    dl1, dr1 = srv.collect(t1)
    assert srv.scene_cuts == 1 and srv._since_key == 1
    base = compile_mst_video_server(GH, GW, **kw)
    kl, kr = base.collect(base.submit_pair(cut_l, cut_r, seed=1))
    assert np.mean(np.abs(dl1 - kl) > 0.5) < 0.01
    assert np.mean(np.abs(dr1 - kr) > 0.5) < 0.01
    seq = render_sequence(2, 3, GH, GW, GD, drift=2.0)
    srv.reset()
    for t in [srv.submit_pair(s.left, s.right, seed=i) for i, s in enumerate(seq)]:
        srv.collect(t)
    assert srv.scene_cuts == 1
