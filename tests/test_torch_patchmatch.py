"""The port's slanted-plane PatchMatch (ops/patchmatch.py,
models/patchmatch.py, pipelines.patchmatch_pipeline) and its weighted
median (ops/postprocess.py) against the JAX package, on the CPU, at
40x56 with max_disp 12, window 15 and tap stride 3.

XLA's CPU backend contracts some multiply-adds into FMAs (a tap's
disparity af*(x+dx) + bf*(y+dy) + cf, the gray luma, the lerps) and torch
does not, so single steps are held from a shared state within a measured
tolerance and whole runs by the share of pixels: a last-bit difference
can flip a near tie between two candidate planes, and the runs part ways
at that pixel.

Measured here: plane_cost within 4.8e-6 relative (held to 2e-5); the plane
fill within 9.5e-6 px (held to 1e-5 relative plus 5e-5); the best-cost
fill and the weighted median equal on 100% of pixels (held to 98% and
99%); the initial planes' d bit-equal, normals within 2.2e-6 (held to
5e-4, as the flat 3DMST frame's), costs within 1.1e-5 relative (held to
1e-4); one round from JAX's own initial state equal within 1e-4 on 99.5%
of pixels or more (held to 98%; reading the old left planes in the right
view's update drops the right view to 45%, which fails that bound); the
pipeline's maps within 0.1 px on 100% of pixels (held to 95%).
"""

import jax
import numpy as np
import pytest
import torch

from stereomatch_tpu import pipelines as jpipe
from stereomatch_tpu.config import PatchMatchConfig, WeightedMedianConfig
from stereomatch_tpu.ops import patchmatch as jpm
from stereomatch_tpu.ops.postprocess import weighted_median as jwm
from stereomatch_tpu_torch import pipelines as tpipe
from stereomatch_tpu_torch import random as trandom
from stereomatch_tpu_torch.interop import key_from_jax, plane_state_from_numpy
from stereomatch_tpu_torch.ops import patchmatch as tpm
from stereomatch_tpu_torch.ops.postprocess import weighted_median as twm
from stereomatch_tpu_torch.synthetic import render_scene
from test_torch_config import port_cfg

H, W, D = 40, 56, 12
METRICS = ("grad_sign", "adgrad")


def _cfg(metric, **kw):
    return PatchMatchConfig(max_disp=float(D), window_size=15, tap_stride=3, metric=metric, **kw)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port runs thousands of small ops here; torch's thread pool only
    adds waits at these sizes when other processes load the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    sc = render_scene(0, H, W, D)
    return sc.left.astype(np.float32), sc.right.astype(np.float32)  # BGR


@pytest.fixture(scope="module")
def planes():
    """Slanted planes with disparities outside [0, max_disp]: many taps
    out of range."""
    rng = np.random.default_rng(1)
    nx = rng.uniform(-0.6, 0.6, (H, W)).astype(np.float32)
    ny = rng.uniform(-0.6, 0.6, (H, W)).astype(np.float32)
    d = rng.uniform(-2.0, D + 2.0, (H, W)).astype(np.float32)
    return nx, ny, d


def _features(bgr):
    """Gray and gradients as both packages' patchmatch_stereo make them."""
    g = (0.114 * bgr[..., 0] + 0.587 * bgr[..., 1] + 0.299 * bgr[..., 2]).astype(np.float32)
    return g, np.stack([np.gradient(g, axis=1), np.gradient(g, axis=0)], -1).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_plane_cost(scene, planes, metric, dtype):
    """Both signs (each view's base), slanted planes, out-of-range taps."""
    lb, rb = scene
    gl, grl = _features(lb)
    gr, grr = _features(rb)
    cfg = _cfg(metric, feature_dtype=dtype)

    @jax.jit
    def jcost(nx, ny, d):
        p = jpm.PlaneState(nx, ny, d)
        return [jpm.plane_cost(bb, gb, gm, p, cfg, s, match_bgr=mb, base_grad=b_g, match_grad=m_g)
                for bb, gb, gm, mb, b_g, m_g, s in ((lb, gl, gr, rb, grl, grr, -1),
                                                    (rb, gr, gl, lb, grr, grl, 1))]

    want = jcost(*planes)
    p = tpm.PlaneState(*map(_t, planes))
    for (bb, gb, gm, mb, b_g, m_g, s), w in zip(((lb, gl, gr, rb, grl, grr, -1),
                                                  (rb, gr, gl, lb, grr, grl, 1)), want):
        got = tpm.plane_cost(_t(bb), _t(gb), _t(gm), p, port_cfg(cfg), s, match_bgr=_t(mb),
                             base_grad=_t(b_g), match_grad=_t(m_g))
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-5, atol=1e-6)


def test_plane_fill_and_view_transform(planes):
    """The plane fill within 1e-5 relative plus 5e-5 (its extension is a
    multiply-add chain); the view transform at x.5 disparities (round half to even)
    bit-equal: it only gathers."""
    nx, ny, d = planes
    rng = np.random.default_rng(2)
    valid = rng.random((H, W)) > 0.4
    valid[3] = False  # a row with no valid pixel: 0
    valid[5, : W // 2] = False  # a left run with no left donor
    want = np.asarray(jax.jit(jpm.plane_fill_occluded)(jpm.PlaneState(nx, ny, d), valid))
    got = tpm.plane_fill_occluded(tpm.PlaneState(*map(_t, planes)), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=5e-5)
    assert (want[3] == 0).all() and (got.numpy()[~valid] != d[~valid]).any()

    dh = np.floor(np.abs(d)) + 0.5  # every disparity half-way: round half to even
    for sign in (-1, 1):
        want = jpm._view_transform(jpm.PlaneState(nx, ny, dh), sign, W)
        got = tpm._view_transform(tpm.PlaneState(_t(nx), _t(ny), _t(dh)), sign, W)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_plane_fill_best_cost(scene, planes):
    """k = 2 donors a side; equal on >= 98% of pixels (a donor's cost can
    tie another's to the last bit)."""
    lb, rb = scene
    gl, _ = _features(lb)
    gr, _ = _features(rb)
    cfg = _cfg("grad_sign")
    valid = np.random.default_rng(3).random((H, W)) > 0.3
    fn = jax.jit(lambda *a: jpm.plane_fill_occluded_best_cost(
        jpm.PlaneState(*a[:3]), a[3], a[4], a[5], a[6], cfg, -1, k=2))
    want = np.asarray(fn(*planes, valid, lb, gl, gr))
    got = tpm.plane_fill_occluded_best_cost(
        tpm.PlaneState(*map(_t, planes)), torch.from_numpy(valid), _t(lb), _t(gl), _t(gr),
        port_cfg(cfg), -1, k=2).numpy()
    assert np.mean(got == want) >= 0.98
    assert np.mean(got[~valid] != planes[2][~valid]) > 0.5


@pytest.mark.parametrize("normalized", [False, True])
def test_weighted_median(scene, normalized):
    """Zero padding, weight 0 out of bounds; equal on >= 99% of pixels (a
    bisection step compares float32 sums of weights against half their
    total)."""
    lb, _ = scene
    rng = np.random.default_rng(4)
    disp = rng.uniform(0.0, D, (H, W)).astype(np.float32)
    occ = rng.random((H, W)) > 0.5
    bgr = lb / 255.0 if normalized else lb
    cfg = WeightedMedianConfig()
    want = np.asarray(jax.jit(lambda d, b, o: jwm(d, b, o, cfg, normalized))(disp, bgr, occ))
    got = twm(_t(disp), _t(bgr), torch.from_numpy(occ), port_cfg(cfg), normalized).numpy()
    assert np.mean(got == want) >= 0.99
    np.testing.assert_array_equal(got[~occ], disp[~occ])
    assert (got[occ] != disp[occ]).any()


@pytest.fixture(scope="module")
def jax_runs(scene):
    """JAX's patchmatch_stereo from key 3 at 0 and 1 rounds, per metric
    (numpy leaves: left nx, ny, d, right nx, ny, d, cost_l, cost_r)."""
    lb, rb = scene
    key = jax.random.PRNGKey(3)
    out = {}
    for metric in METRICS:
        for it in (0, 1):
            res = jpm.patchmatch_stereo(key, lb, rb, _cfg(metric, iterations=it))
            out[metric, it] = [np.asarray(x) for x in jax.tree_util.tree_leaves(res)]
    return key, out


@pytest.mark.parametrize("metric", METRICS)
def test_init_matches_jax(scene, jax_runs, metric):
    """Random init: the uniform draws are bit-exact, so d is; the normals
    pass through cos, sin and sqrt (an ulp apart in XLA and torch)."""
    lb, rb = scene
    key, runs = jax_runs
    cfg = port_cfg(_cfg(metric, iterations=0))
    got = tpm.patchmatch_stereo(key_from_jax(key, "cpu"), _t(lb), _t(rb), cfg)
    got = [x.numpy() for x in jax.tree_util.tree_leaves(got)]
    want = runs[metric, 0]
    for i in (2, 5):
        np.testing.assert_array_equal(got[i], want[i])
    for i in (0, 1, 3, 4):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=5e-4)
    for i in (6, 7):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4)


def _share(a, b, tol=1e-4):
    return float(np.mean(np.abs(a - b) <= tol))


@pytest.mark.parametrize("metric", METRICS)
def test_one_round_from_jax_state(scene, jax_runs, metric):
    """One port round from JAX's own initial planes and costs against
    JAX's one-round run: planes and costs within 1e-4 on >= 98% of pixels.
    The round is Jacobi and ordered: the right view's update must read the
    new left planes; reading the old ones misses that bound."""
    lb, rb = scene
    key, runs = jax_runs
    j0, j1 = runs[metric, 0], runs[metric, 1]
    cfg = port_cfg(_cfg(metric, iterations=1))
    views = tpm._Views(_t(lb), _t(rb), cfg)
    left = plane_state_from_numpy(*j0[0:3], device="cpu")
    right = plane_state_from_numpy(*j0[3:6], device="cpu")
    key_i = trandom.split(trandom.split(key_from_jax(key, "cpu"), 3)[2], 1)[0]
    jump = tpm._jump_schedule(H, W, 1)[0]
    ladder = tpm._refine_ladder(cfg.max_disp)
    got = tpm._round(key_i, jump, left, right, _t(j0[6]), _t(j0[7]), views, ladder)
    got = [x.numpy() for x in jax.tree_util.tree_leaves(got)]
    for g, w in zip(got, j1):
        assert _share(g, w) >= 0.98

    k1, k2 = trandom.split(key_i)
    stale, _ = tpm._update_view(k2, jump, right, _t(j0[7]), left, 1, views, ladder)
    assert _share(stale.d.numpy(), j1[5]) < 0.9


def test_pipeline_matches_jax(jax_runs):
    """pipelines.patchmatch_pipeline (RGB in, numpy out, seed 0, the CLI's
    adgrad metric, one round: the JAX program `jax_runs` compiled) against
    JAX's on another scene: both views within 0.1 px on >= 95% of pixels."""
    sc = render_scene(1, H, W, D)
    rgb_l, rgb_r = sc.left[..., ::-1].copy(), sc.right[..., ::-1].copy()
    cfg = _cfg("adgrad", iterations=1)
    want = jpipe.patchmatch_pipeline(rgb_l, rgb_r, cfg, seed=0)
    got = tpipe.patchmatch_pipeline(rgb_l, rgb_r, port_cfg(cfg), seed=0, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (H, W)
        assert _share(g, w, 0.1) >= 0.95
    raw = tpipe.patchmatch_pipeline(rgb_l, rgb_r, port_cfg(cfg), seed=0, postprocess=False,
                                    device="cpu")
    assert not np.array_equal(raw[0], got[0])
