"""The port's server (stereomatch_tpu_torch/serving.py) end to end on the
CPU: frame parity with the JAX server on the same pair and seed, the
executor's ticket semantics, and the absolute ground-truth gates.

Parity bound: >= 95% of pixels within 0.1 px, the JAX package's own bound
for two paths through the same composition (tests/test_mst_seeded.py:117).
The packages sum float32 in different orders (XLA fuses multiply-adds),
so a near-tie between candidate labels can resolve differently."""

import numpy as np
import pytest
import torch

from stereomatch_tpu.config import production_mst_config
from stereomatch_tpu.eval import disparity_metrics
from stereomatch_tpu.serving import compile_sgbm_mst_server as j_server
from stereomatch_tpu.synthetic import render_scene, scene_eval_mask
from stereomatch_tpu_torch.models.sgbm_mst import sgbm_mst_stereo_fused
from stereomatch_tpu_torch.ops.postprocess import lr_consistency
from stereomatch_tpu_torch.serving import StereoStreamServer, compile_sgbm_mst_server
from test_torch_config import port_cfg

H, W, D = 48, 64, 16
CFG = production_mst_config(D, on_tpu=False, min_cc_size=20, c=800.0)
TCFG = port_cfg(CFG)  # the same fields in the port's own config


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    img = (rng.random((H, W, 3)) * 255).astype(np.float32)
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    return img, np.roll(img, -3, axis=1)


@pytest.mark.parametrize("guided", [True, False])
def test_frame_matches_jax_server(pair, guided):
    left, right = pair
    js = j_server(H, W, cfg=CFG, volume_guided=guided)
    want = js.collect(js.submit_pair(left, right, seed=0))
    ts = compile_sgbm_mst_server(H, W, cfg=TCFG, device="cpu", volume_guided=guided)
    got = ts.collect(ts.submit_pair(left, right, seed=0))
    for w_, g_ in zip(want, got):
        assert g_.shape == (H, W) and g_.dtype == np.float32 and np.isfinite(g_).all()
        assert (np.abs(g_ - w_) < 0.1).mean() >= 0.95


def test_tickets_backpressure_and_drain(pair):
    left, right = pair
    srv = compile_sgbm_mst_server(H, W, cfg=TCFG, device="cpu", fine_iterations=1, capacity=1)
    t0 = srv.submit_pair(left, right)
    t1 = srv.submit_pair(left, right)  # capacity 1: frame 0 finishes first
    assert (t0, t1) == (0, 1) and len(srv._queue) == 1 and 0 in srv._done
    got1 = srv.collect(t1)
    got0 = srv.collect(t0)
    # the default seed is the ticket: frame 1 equals an explicit seed=1 run
    again = srv.collect(srv.submit_pair(left, right, seed=1))
    for x, y in zip(got1, again):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(got0, got1))
    t3, t4 = srv.submit_pair(left, right), srv.submit_pair(left, right)
    assert [len(o) for o in srv.drain()] == [2, 2] and (t3, t4) == (3, 4)
    with pytest.raises(KeyError):
        srv.collect(t3)
    with pytest.raises(ValueError, match="built for"):
        srv.submit_pair(left[:-1], right[:-1])


def test_unported_options_raise():
    for kw in (dict(staged=True), dict(cache_dir="x")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            compile_sgbm_mst_server(H, W, cfg=TCFG, device="cpu", **kw)
    with pytest.raises(ValueError):
        StereoStreamServer(lambda: (), "cpu", capacity=0)


def test_retries_replay_a_failed_frame(pair):
    """retries=1: a frame whose output copy to the host raises is uploaded
    again from the host inputs and rerun with its own key."""
    left, right = pair
    srv = compile_sgbm_mst_server(H, W, cfg=TCFG, device="cpu", fine_iterations=1, retries=1)
    want = srv.collect(srv.submit_pair(left, right, seed=0))

    class _Lost:
        def cpu(self):
            raise RuntimeError("CUDA error: unspecified launch failure")

    frame, calls = srv.pipeline, []

    def flaky(*args):
        calls.append(1)
        return (_Lost(), _Lost()) if len(calls) == 1 else frame(*args)

    srv.pipeline = flaky
    got = srv.collect(srv.submit_pair(left, right, seed=0))
    assert srv.failures == 1 and len(calls) == 2
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_fused_entry_is_the_server_frame(pair):
    """sgbm_mst_stereo_fused = the server frame + LR check of the left map."""
    from stereomatch_tpu_torch.apps.stereo_yin import builtin_cost_volumes

    left, right = pair
    srv = compile_sgbm_mst_server(H, W, cfg=TCFG, device="cpu", volume_guided=False)
    dl, dr = srv.collect(srv.submit_pair(left, right, seed=3))
    vl, vr = builtin_cost_volumes(torch.from_numpy(left).flip(-1),
                                  torch.from_numpy(right).flip(-1), D, guided=False)
    out = sgbm_mst_stereo_fused(left, right, vl, vr, TCFG, seed=3, device="cpu")
    np.testing.assert_array_equal(out.right_disp.numpy(), dr)
    checked, valid = lr_consistency(torch.from_numpy(dl), torch.from_numpy(dr), float(D), fill=False)
    np.testing.assert_array_equal(out.left_disp.numpy(), checked.numpy())
    np.testing.assert_array_equal(out.left_valid.numpy(), valid.numpy())


@pytest.mark.parametrize("guided", [True, False])
def test_absolute_gt_gates(guided):
    """The production recipe at 240x320x32 meets the absolute gates of
    tests/test_mst_seeded.py (valid > 0.35, EPE < 1.2 px, bad2 < 8%)."""
    sc = render_scene(1, 240, 320, 32)
    cfg = port_cfg(production_mst_config(32, on_tpu=False, min_cc_size=100, c=2000.0,
                                         forest_backend="device"))
    srv = compile_sgbm_mst_server(240, 320, cfg=cfg, device="cpu", volume_guided=guided)
    dl, dr = srv.collect(srv.submit_pair(sc.left, sc.right, seed=0))
    checked, valid = lr_consistency(torch.from_numpy(dl), torch.from_numpy(dr), 32.0, fill=False)
    v = valid.numpy() & scene_eval_mask(sc)
    assert v.mean() > 0.35, v.mean()
    mm = disparity_metrics(checked.numpy(), sc.disp_left, v)
    assert mm["epe"] < 1.2, mm
    assert mm["bad2"] < 0.08, mm
