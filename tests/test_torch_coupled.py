"""The port's coupled engines against the JAX package, on the CPU: the
coupled PatchMatch <-> Huber-ROF engine (ops/coupled.py,
models/coupled.py::coupled_patchmatch_stereo) at 40x56 with 13 disparity
slices (max_disp 12), window 15 and tap stride 3, on a noisy slanted cost
volume (tests/test_coupled.py's construction) and a rendered scene's
colours; and the AL-TGV <-> coupled-WTA engine (coupled_wta_stereo) on
tests/test_coupled.py's own problem (48x64, 24 slices, 40 rounds).

As for PatchMatch (tests/test_torch_patchmatch.py), XLA contracts some
multiply-adds into FMAs and torch does not: the ops are held within a
measured tolerance, a data-step round from a shared state and the whole
engine by the share of pixels. Measured here: the hybrid and coupled costs
within 1.3e-6 relative (held to 2e-5); 10 Huber-ROF steps within 7.2e-7
(held to 1e-5 absolute); one `_coupled_update` from a shared state equal
within 1e-4 on 100% of pixels (held to 98%); the engine at 2 outer rounds:
its smoothed field within 1e-3 px on 99.9% of pixels (at most 8.7e-3 px
apart) and its disparities within 0.1 px on 100% (both held to 95%).
coupled_wta_stereo at 40 rounds of 10 TGV steps: both maps within 4.7e-5
px of JAX's on every pixel, flat and textured guide, TGV and TV (held to
1e-3 px on >= 99% of pixels); its theta_inv schedule equals XLA's float32
bit for bit (XLA fuses 1 - beta i into one multiply-add).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.config import CoupledConfig
from stereomatch_tpu.models import coupled as jmodel
from stereomatch_tpu.ops import coupled as jops
from stereomatch_tpu.ops.patchmatch import PlaneState as JPlanes
from stereomatch_tpu.ops.tgv import TGVParams as JTGVParams
from stereomatch_tpu_torch import random as trandom
from stereomatch_tpu_torch.interop import key_from_jax, plane_state_from_numpy
from stereomatch_tpu_torch.models import coupled as tmodel
from stereomatch_tpu_torch.ops import coupled as tops
from stereomatch_tpu_torch.ops.tgv import TGVParams
from stereomatch_tpu_torch.synthetic import render_scene
from test_torch_config import port_cfg

H, W, ND = 40, 56, 13
CFG = CoupledConfig(max_disp=ND - 1, window_size=15, tap_stride=3)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Thousands of small ops: torch's thread pool only adds waits here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    """(BGR colours, noisy volume whose clean minimum follows d = 0.15x + 2,
    slanted planes with out-of-range disparities, fields near them)."""
    rng = np.random.default_rng(21)
    bgr = render_scene(0, H, W, ND - 1).left.astype(np.float32)
    xs = np.arange(W, dtype=np.float32)[None, :]
    d_true = 0.15 * xs + 2.0 + np.zeros((H, 1), np.float32)
    ds = np.arange(ND, dtype=np.float32)[None, None, :]
    vol = np.minimum(np.abs(ds - d_true[..., None]) * 0.12, 0.5)
    vol = (vol + rng.random((H, W, ND)) * 0.6).astype(np.float32)
    nx = rng.uniform(-0.5, 0.5, (H, W)).astype(np.float32)
    ny = rng.uniform(-0.5, 0.5, (H, W)).astype(np.float32)
    d = rng.uniform(-1.0, ND + 1.0, (H, W)).astype(np.float32)
    fields = [(d / (ND - 1) + rng.normal(0, 0.05, (H, W))).astype(np.float32),
              (nx * 0.5).astype(np.float32), (ny * 0.5).astype(np.float32),
              rng.normal(0, 0.3, (H, W, 2)).astype(np.float32),
              rng.normal(0, 0.3, (H, W, 4)).astype(np.float32)]
    return bgr, vol, (nx, ny, d), fields


def test_hybrid_and_coupled_cost(problem):
    """Both signs; the coupled cost at theta_d 30, theta_n 3."""
    bgr, vol, planes, fields = problem

    @jax.jit
    def jcost(nx, ny, d, f):
        p, fl = JPlanes(nx, ny, d), jops.HuberFields(*f)
        return ([jops.hybrid_plane_cost(bgr, vol, p, CFG, s) for s in (-1, 1)],
                jops.coupled_plane_cost(bgr, vol, p, fl, CFG, -1, 30.0, 3.0))

    want_h, want_c = jcost(*planes, fields)
    tp = plane_state_from_numpy(*planes, device="cpu")
    cfg = port_cfg(CFG)
    for s, w in zip((-1, 1), want_h):
        got = tops.hybrid_plane_cost(_t(bgr), _t(vol), tp, cfg, s)
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-5, atol=1e-7)
    got = tops.coupled_plane_cost(_t(bgr), _t(vol), tp, tops.HuberFields(*map(_t, fields)), cfg,
                                  -1, 30.0, 3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_c), rtol=2e-5, atol=1e-7)


def test_huber_rof_field_steps(problem):
    """10 dual + primal steps toward the data fields, edge weights from the
    scene's gray."""
    bgr, _, (nx, ny, d), fields = problem
    gp = np.exp(-np.random.default_rng(5).random((H, W)) * 3.0).astype(np.float32)
    data = ((d / (ND - 1)).astype(np.float32), nx, ny)

    @jax.jit
    def jsteps(f):
        st = jops.HuberFields(*f)
        for _ in range(10):
            st = jops.huber_rof_field_step(st, *data, gp, 20.0, 2.0, CFG.huber_eps)
        return st

    want = jsteps(fields)
    st = tops.HuberFields(*map(_t, fields))
    for _ in range(10):
        st = tops.huber_rof_field_step(st, *map(_t, data), _t(gp), 20.0, 2.0, CFG.huber_eps)
    for g, w in zip(st, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_coupled_update_from_shared_state(problem):
    """One data-step round (the current label re-scored, 8 neighbours at
    face value, the annealed refinement with its (d, nz, nx, ny) draw) from
    the same planes, fields, key and theta: planes and costs within 1e-4
    on >= 98% of pixels."""
    bgr, vol, planes, fields = problem
    key = jax.random.PRNGKey(7)
    theta = (jnp.float32(30.0), jnp.float32(3.0))
    want = jax.jit(lambda k, p, f, td, tn: jmodel._coupled_update(
        k, JPlanes(*p), jops.HuberFields(*f), bgr, vol, CFG, -1, td, tn))(key, planes, fields,
                                                                          *theta)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    got = tmodel._coupled_update(
        key_from_jax(key, "cpu"), plane_state_from_numpy(*planes, device="cpu"),
        tops.HuberFields(*map(_t, fields)), _t(bgr), _t(vol), port_cfg(CFG), -1,
        torch.tensor(30.0), torch.tensor(3.0))
    got = [x.numpy() for x in jax.tree_util.tree_leaves(got)]
    for g, w in zip(got, want):
        assert np.mean(np.abs(g - w) <= 1e-4) >= 0.98
    assert np.mean(got[2] != planes[2]) > 0.5  # the round moved the planes


def test_coupled_patchmatch_stereo_matches_jax(problem):
    """The whole engine at 2 outer rounds (10 smoothing steps each) from
    key 0: the smoothed field within 1e-3 px on >= 95% of pixels, the
    disparities within 0.1 px on >= 95%."""
    bgr, vol, _, _ = problem
    cfg = CoupledConfig(max_disp=ND - 1, window_size=15, tap_stride=3, outer_iterations=2)
    want = jmodel.coupled_patchmatch_stereo(jax.random.PRNGKey(0), bgr, vol, cfg)
    got = tmodel.coupled_patchmatch_stereo(trandom.PRNGKey(0, "cpu"), _t(bgr), _t(vol),
                                           port_cfg(cfg))
    assert np.mean(np.abs(got.smoothed.numpy() - np.asarray(want.smoothed)) <= 1e-3) >= 0.95
    assert np.mean(np.abs(got.disparity.numpy() - np.asarray(want.disparity)) <= 0.1) >= 0.95
    assert got.smoothed.shape == (H, W) and torch.isfinite(got.smoothed).all()


def test_theta_schedule_is_xla_float32():
    """The ramp as XLA evaluates the JAX package's f32 expression (checked
    against a jitted scan of it): 5, 10, ..., 50 exactly at 10 rounds."""
    def outer(c, it):
        t = it.astype(jnp.float32) / 9
        return c, (5.0 + (50.0 - 5.0) * t, 0.5 + (5.0 - 0.5) * t)

    _, (td, tn) = jax.jit(lambda: jax.lax.scan(outer, 0, jnp.arange(10)))()
    assert tmodel._theta_schedule(5.0, 50.0, 10) == np.asarray(td).tolist()
    assert tmodel._theta_schedule(0.5, 5.0, 10) == np.asarray(tn).tolist()
    assert tmodel._theta_schedule(5.0, 50.0, 1) == [5.0]


@pytest.fixture(scope="module")
def wta_problem():
    """tests/test_coupled.py's problem: a noisy volume whose clean minimum
    follows d = 0.15x + 4, and a flat and a textured guide."""
    rng = np.random.default_rng(21)
    h, w, nd = 48, 64, 24
    xs = np.arange(w, dtype=np.float32)[None, :]
    d_true = 0.15 * xs + 4.0 + np.zeros((h, 1), np.float32)
    ds = np.arange(nd, dtype=np.float32)[None, None, :]
    clean = np.minimum(np.abs(ds - d_true[..., None]) * 0.12, 0.5)
    vol = (clean + rng.random((h, w, nd)).astype(np.float32) * 0.6).astype(np.float32)
    guides = {"flat": np.full((h, w), 128.0, np.float32),
              "textured": render_scene(0, h, w, nd).left.astype(np.float32).mean(-1)}
    return vol, guides, d_true


@pytest.mark.parametrize("tgv", [True, False])
@pytest.mark.parametrize("guide", ["flat", "textured"])
def test_coupled_wta_stereo_matches_jax(wta_problem, guide, tgv):
    """tests/test_coupled.py's configuration (40 rounds, 10 TGV steps each,
    lambda_s 2): the WTA field and the smoothed field within 1e-3 px on >=
    99% of pixels; on the flat guide the engine beats raw WTA as JAX's
    test demands."""
    vol, guides, d_true = wta_problem
    cfg = CoupledConfig(max_disp=vol.shape[2] - 1, outer_iterations=40, smooth_iters=10,
                        lambda_d=1.0, theta_inv0=1.0, beta_anneal=0.01)
    want = jmodel.coupled_wta_stereo(jnp.asarray(vol), jnp.asarray(guides[guide]), cfg,
                                     JTGVParams(lambda_s=2.0), tgv)
    got = tmodel.coupled_wta_stereo(_t(vol), _t(guides[guide]), port_cfg(cfg),
                                    TGVParams(lambda_s=2.0), tgv, device="cpu")
    assert got.planes is None and got.disparity.shape == vol.shape[:2]
    for g, w in ((got.disparity, want.disparity), (got.smoothed, want.smoothed)):
        assert np.mean(np.abs(g.numpy() - np.asarray(w)) <= 1e-3) >= 0.99
    if guide == "flat" and tgv:
        from stereomatch_tpu_torch.ops.select import wta_disparity

        inner = np.s_[4:-4, 4:-4]
        mae_wta = np.abs(wta_disparity(_t(vol), 0).numpy() - d_true)[inner].mean()
        assert np.abs(got.disparity.numpy() - d_true)[inner].mean() < 0.6 * mae_wta


@pytest.mark.parametrize("theta0,beta,n", [(1.0, 0.01, 200), (1.0, 0.03, 40), (0.7, 0.013, 120)])
def test_theta_inv_schedule_is_xla_float32(theta0, beta, n):
    """The carried theta_inv / max(1 - beta i, 0.05) as XLA evaluates the
    JAX engine's float32 scan (a jitted scan of the same expression), bit
    for bit, into the floor of 0.05."""
    def outer(th, i):
        return th / jnp.maximum(1.0 - beta * i.astype(jnp.float32), 0.05), th

    _, want = jax.jit(lambda: jax.lax.scan(outer, jnp.float32(theta0), jnp.arange(n)))()
    assert tmodel._theta_inv_schedule(theta0, beta, n) == np.asarray(want).tolist()
