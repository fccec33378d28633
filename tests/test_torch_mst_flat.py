"""The port's flat random-init 3DMST (models/mst.py::mst_stereo and
mst_stereo_fused, pipelines.py) and its host-forest tree filter against
the JAX package, on shared forests, keys and volumes.

Tolerances: tree_filter on a host forest 1e-4 (the JAX package's own
bound, tests/test_torch_mst.py); the optimizer's min costs 1e-3; the
frames' maps within 0.1 px on >= 95% of pixels (the bound of
tests/test_torch_serving.py: float32 sums in other orders can resolve a
near-tie between candidate labels differently).

init_labels cannot be bit-exact: its uniform draws are (held bit for bit
below), but XLA's CPU cos and sin differ from torch's by 1 ulp on about 5%
of inputs and its sqrt on about 0.6%, and the plane's slopes divide by a
normal component nz as small as 1e-4, which magnifies those ulps. So the
planes are held where that magnification does not reach: the unit normals
within 5e-4 (measured <= 2.4e-4 over three keys at 120x160), the plane's
disparity at its own pixel within 1e-6 of the size of its terms (measured
<= 1.5e-7), and >= 80% of the nodes' (a, b, c) bit-equal (measured 90.6-
90.8%). The optimizer is then held from JAX's own initial labels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu import native as jnative
from stereomatch_tpu import pipelines as jpipelines
from stereomatch_tpu.config import CostVolumeConfig, MSTConfig
from stereomatch_tpu.eval import disparity_metrics
from stereomatch_tpu.models import mst as jmodels
from stereomatch_tpu.ops import mst as jmst
from stereomatch_tpu.ops.cost import adgrad_bgr_volumes
from stereomatch_tpu.synthetic import render_scene, scene_eval_mask
from stereomatch_tpu_torch import pipelines as tpipelines
from stereomatch_tpu_torch import random as trandom
from stereomatch_tpu_torch.interop import key_from_jax, native_forest_from_numpy
from stereomatch_tpu_torch.models import mst as tmodels
from stereomatch_tpu_torch.ops import mst as tmst
from test_torch_config import port_cfg

GAMMA = 1.0 / 12.0


def _shared_host_forest(h=48, w=64, delta=4.0, c=800.0, min_size=20, seed=1, contrast=1.0):
    """One native forest of a scene (its colours and c scaled by
    `contrast`), as JAX's and the port's ForestArrays."""
    img = render_scene(seed, h, w, min(32, w // 4)).left * contrast
    wr, wd = jnative.color_edge_weights(img)
    f = jnative.build_forest(wr, wd, c * contrast, min_size, GAMMA, delta)
    return jmst.forest_arrays(f), tmst.forest_arrays(
        native_forest_from_numpy(dataclasses.asdict(f)), "cpu")


def _close(got, want, bound=0.95):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    share = (np.abs(got - want) < 0.1).mean()
    assert share >= bound, share


def _assert_frames_close(t, j):
    _close(t.left_disp.numpy(), j.left_disp)
    _close(t.right_disp.numpy(), j.right_disp)
    assert (t.left_valid.numpy() == np.asarray(j.left_valid)).mean() >= 0.95


@pytest.fixture(scope="module")
def small_pair():
    """A 48x64 scene, its adgrad volumes scaled to the [0, 0.5] cost
    convention, and a config with a few trees at this size."""
    sc = render_scene(2, 48, 64, 16)
    lv, rv = (np.asarray(v) for v in adgrad_bgr_volumes(
        sc.left, sc.right, CostVolumeConfig(min_disp=0, max_disp=15)))
    s = 0.5 / max(lv.max(), rv.max())
    cfg = MSTConfig(max_disp=16, iterations=4, min_cc_size=20, c=800.0)
    return sc, lv * s, rv * s, cfg


@pytest.mark.parametrize("delta,contrast", [(1.0, 1.0), (4.0, 1.0), (40.0, 0.02)])
@pytest.mark.parametrize("carry_iters", [1, 2])
def test_tree_filter_host_forest(rng, delta, contrast, carry_iters):
    """At delta 1 and 4 on the scene. At delta 40 the exp-factorized sums
    keep float32 precision only where a segment's depth range is small
    (the reason max_log_range defaults to 4), so this case runs on a
    low-contrast view, whose segments are long (one of 2770 nodes, more
    than a 1024-element K2 tile) and shallow (depth range about 6); the
    textured scene at delta 40 is the next test's."""
    fj, ft = _shared_host_forest(delta=delta, contrast=contrast)
    assert ft.cut_child_idx.shape[0] == 3
    cost = (rng.random((7, 48 * 64)) * 0.5).astype(np.float32)
    want = np.asarray(jmst.tree_filter(jnp.asarray(cost), fj, carry_iters))
    got = tmst.tree_filter(torch.from_numpy(cost), ft, carry_iters).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    inv_j = np.asarray(jmst.aggregation_norm_inv(fj, carry_iters))
    inv_t = tmst.aggregation_norm_inv(ft, carry_iters).numpy()
    np.testing.assert_allclose(inv_t, inv_j, rtol=1e-4, atol=1e-4)


def _two_pass_f64(cost, parent, w_exp):
    """The reference's two-pass tree-filter recurrence in float64, level by
    level of depth: U(p) = c(p) + sum over children w_q U(q), then
    D(p) = w_p D(parent) + (1 - w_p^2) U(p), D = U at tree roots."""
    n = parent.size
    ar = np.arange(n)
    depth, cur = np.zeros(n, np.int64), ar
    while (moved := parent[cur] != cur).any():
        depth += moved
        cur = parent[cur]
    levels = [np.nonzero(depth == k)[0] for k in range(depth.max() + 1)]
    w = w_exp.astype(np.float64)
    u = cost.astype(np.float64)
    for q in levels[:0:-1]:
        np.add.at(u, (slice(None), parent[q]), w[q] * u[:, q])
    d = u.copy()
    for q in levels[1:]:
        d[:, q] = w[q] * d[:, parent[q]] + (1.0 - w[q] ** 2) * u[:, q]
    return d


@pytest.mark.parametrize("seed,c,min_size", [(2, 800.0, 20), (1, 2000.0, 100)])
def test_tree_filter_delta40_textured_tracks_jax(seed, c, min_size):
    """At delta 40 on the textured 120x160 scene the exp-factorized sums
    cancel in both packages, far from the float64 two-pass recurrence (JAX
    by 1.4 to 7.1e3 over 12 scenes, inputs and configs, on values of 1-4).
    The port's twin makes JAX's adds in JAX's order (the block prefix as a
    triangular product, the carries in associative_scan's order), so what
    still parts them is XLA's and torch's exp, an ulp apart on about 9% of
    inputs: the port's largest error from float64 stays within 1.1x of
    JAX's (measured 0.98-1.01 over those 12 cases), and >= 98% of nodes lie
    within 1e-4 of JAX's (measured 98.3-99.5%)."""
    h, w = 120, 160
    fj, ft = _shared_host_forest(h, w, delta=40.0, c=c, min_size=min_size, seed=seed)
    cost = (np.random.default_rng(0).random((3, h * w)) * 0.5).astype(np.float32)
    want = _two_pass_f64(cost, ft.parent_node.numpy(), ft.w_exp.numpy())
    jax_out = np.asarray(jmst.tree_filter(jnp.asarray(cost), fj, 2))
    got = tmst.tree_filter(torch.from_numpy(cost), ft, 2).numpy()
    err_jax, err_port = np.abs(jax_out - want).max(), np.abs(got - want).max()
    assert err_jax > 1.0  # the case does stress the float32 sums
    assert err_port <= 1.1 * err_jax, (err_port, err_jax)
    assert (np.abs(got - jax_out) <= 1e-4).mean() >= 0.98


@pytest.mark.parametrize("seed", [3, 11])
def test_init_labels_vs_jax(seed):
    fj, ft = _shared_host_forest(120, 160, c=2000.0, min_size=100)
    key = jax.random.PRNGKey(seed)
    tkey = key_from_jax(key, "cpu")
    n = 120 * 160
    for kj, kt in zip(jax.random.split(key, 3), trandom.split(tkey, 3)):
        np.testing.assert_array_equal(trandom.uniform(kt, (n,)).numpy(),
                                      np.asarray(jax.random.uniform(kj, (n,))))
    a, b, c = (np.asarray(x, np.float64) for x in jmst.init_labels(key, fj, 32))
    at, bt, ct = (x.numpy().astype(np.float64) for x in tmst.init_labels(tkey, ft, 32))

    def normal(a, b):
        s = np.sqrt(a * a + b * b + 1.0)
        return np.stack([-a / s, -b / s, 1.0 / s])

    np.testing.assert_allclose(normal(at, bt), normal(a, b), rtol=0, atol=5e-4)
    pix = ft.pixel_of_node.numpy()
    px, py = (pix % 160).astype(np.float64), (pix // 160).astype(np.float64)
    scale = np.abs(a) * px + np.abs(b) * py + np.abs(c) + 1.0
    d_j, d_t = a * px + b * py + c, at * px + bt * py + ct
    assert (np.abs(d_t - d_j) / scale).max() <= 1e-6
    assert (d_j > -1.0).all() and (d_j < 33.0).all()
    assert ((a == at) & (b == bt) & (c == ct)).mean() >= 0.8


def test_random_init_optimize_from_jax_labels(small_pair):
    """The random-init optimizer from JAX's own initial labels (handed in
    with an infinite min cost, the init_state=None path's start) follows
    JAX's init_state=None run; the port's own init_state=None run equals
    its run from its own init_labels."""
    _, lv, _, cfg = small_pair
    fj, ft = _shared_host_forest()
    tcfg = port_cfg(cfg)
    key = jax.random.PRNGKey(7)
    tkey = key_from_jax(key, "cpu")
    kw = dict(max_neighbors=4, iterations=4)
    *_, mc_j = jmst.mst_pms_optimize(key, jnp.asarray(lv), fj, cfg, **kw)
    k0 = jax.random.split(key)[1]
    inf = torch.full((48 * 64,), float("inf"))
    init = tuple(torch.from_numpy(np.array(x)) for x in jmst.init_labels(k0, fj, 16))
    *_, mc_t = tmst.mst_pms_optimize(tkey, torch.from_numpy(lv), ft, tcfg, init_state=(*init, inf),
                                     **kw)
    np.testing.assert_allclose(mc_t.numpy(), np.asarray(mc_j), rtol=1e-3, atol=1e-3)
    own = tmst.mst_pms_optimize(tkey, torch.from_numpy(lv), ft, tcfg, **kw)
    init_t = tmst.init_labels(trandom.split(tkey)[1], ft, 16)
    again = tmst.mst_pms_optimize(tkey, torch.from_numpy(lv), ft, tcfg, init_state=(*init_t, inf),
                                  **kw)
    for x, y in zip(own, again):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert torch.isfinite(own[3]).all()


@pytest.mark.parametrize("backend", ["host", "device"])
def test_mst_stereo_vs_jax(small_pair, backend):
    sc, lv, rv, cfg = small_pair
    cfg = dataclasses.replace(cfg, forest_backend=backend)
    want = jmodels.mst_stereo(sc.left, sc.right, lv, rv, cfg, seed=0, max_neighbors=4)
    got = tmodels.mst_stereo(sc.left, sc.right, lv, rv, port_cfg(cfg), seed=0, max_neighbors=4,
                             device="cpu")
    _assert_frames_close(got, want)


def test_mst_stereo_fused_vs_jax(small_pair):
    sc, lv, rv, cfg = small_pair
    want = jmodels.mst_stereo_fused(sc.left, sc.right, lv, rv, cfg, seed=1, max_neighbors=4)
    got = tmodels.mst_stereo_fused(sc.left, sc.right, lv, rv, port_cfg(cfg), seed=1,
                                   max_neighbors=4, device="cpu")
    _assert_frames_close(got, want)
    # the same RNG stream and stages as mst_stereo on the device forest
    dev = tmodels.mst_stereo(sc.left, sc.right, lv, rv,
                             port_cfg(dataclasses.replace(cfg, forest_backend="device")), seed=1,
                             max_neighbors=4, device="cpu")
    for x, y in zip(got, dev):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_mst_pipeline_vs_jax(small_pair):
    sc, _, _, cfg = small_pair
    rgb_l, rgb_r = sc.left[..., ::-1], sc.right[..., ::-1]
    want = jpipelines.mst_pipeline(rgb_l, rgb_r, cfg=cfg, seed=2)
    got = tpipelines.mst_pipeline(rgb_l, rgb_r, cfg=port_cfg(cfg), seed=2, device="cpu")
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        _close(g, w)
    with pytest.raises(ValueError, match="size mismatch"):
        tpipelines.mst_pipeline(rgb_l, rgb_r[:-1], cfg=port_cfg(cfg), device="cpu")


def test_sgbm_mst_pipeline_vs_jax():
    """The seeded composition with MSTConfig's defaults (host forest,
    c=5000, min_cc_size=200: one or a few trees at this size) but for the
    label range."""
    sc = render_scene(4, 60, 80, 16)
    rgb_l, rgb_r = sc.left[..., ::-1], sc.right[..., ::-1]
    cfg = MSTConfig(max_disp=16)
    want = jpipelines.sgbm_mst_pipeline(rgb_l, rgb_r, cfg=cfg, seed=0, fine_iterations=4)
    got = tpipelines.sgbm_mst_pipeline(rgb_l, rgb_r, cfg=port_cfg(cfg), seed=0, fine_iterations=4,
                                       device="cpu")
    for g, w in zip(got, want):
        _close(g, w)


def test_to_bgr255():
    rgb = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    got = tpipelines.to_bgr255(rgb, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpipelines.to_bgr255(rgb)))
    assert got.dtype == torch.float32
    gray = tpipelines.to_bgr255(rgb[..., 0], "cpu")
    np.testing.assert_array_equal(gray.numpy(), np.asarray(jpipelines.to_bgr255(rgb[..., 0])))


def test_mst_stereo_absolute_gt():
    """The port's flat frame on the host forest at the GT battery's gates
    (tests/test_gt_battery.py::test_mst_absolute_gt): LR-valid share
    > 0.35, EPE < 1.2, bad2 < 0.08 on the LR-validated left map."""
    sc = render_scene(1, 120, 160, 16)
    m = scene_eval_mask(sc)
    lv, rv = (np.asarray(v) for v in adgrad_bgr_volumes(
        sc.left, sc.right, CostVolumeConfig(min_disp=0, max_disp=15)))
    s = 0.5 / max(lv.max(), rv.max())
    cfg = port_cfg(MSTConfig(max_disp=16, iterations=8, min_cc_size=100, c=2000.0))
    out = tmodels.mst_stereo(sc.left, sc.right, lv * s, rv * s, cfg, seed=0, max_neighbors=4,
                             device="cpu")
    valid = out.left_valid.numpy() & m
    assert valid.mean() > 0.35
    mm = disparity_metrics(out.left_disp.numpy(), sc.disp_left, valid)
    assert mm["epe"] < 1.2, mm
    assert mm["bad2"] < 0.08, mm
