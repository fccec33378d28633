"""The port's smoothness priors (ops/tgv.py, ops/nltgv.py and
models/mst.py::_apply_smoothness) against the JAX package, on the CPU, at
40x56 on a rendered scene's colours and its ground truth as the field to
refine (noised, in [0, 1]).

XLA contracts some multiply-adds into FMAs on the CPU and torch does not,
so single steps differ in their last bits and the clip and the
over-relaxation 2 u_t - u carry that along. Measured here after 100
iterations: tgv2_refine (TGV and TV) within 2.4e-7 of JAX, nl2tgv_refine
(each of TGV / TV with the Lagrangian update on and off) within 5.4e-7,
the diffusion tensor, line response and support weights within 2.4e-7.
All are held to 1e-5 absolute on the [0, 1] field; `_apply_smoothness`
returns pixels, so it is held to 1e-5 times the disparity span.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.config import MSTConfig
from stereomatch_tpu.models import mst as jmst
from stereomatch_tpu.ops import nltgv as jnl
from stereomatch_tpu.ops import tgv as jtgv
from stereomatch_tpu_torch.models import mst as tmst
from stereomatch_tpu_torch.ops import nltgv as tnl
from stereomatch_tpu_torch.ops import tgv as ttgv
from stereomatch_tpu_torch.synthetic import render_scene
from test_torch_config import port_cfg

H, W, ND = 40, 56, 12
ATOL = 1e-5


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
    """(BGR in [0, 255], gray in [0, 1], noisy [0, 1] field, a sparse line
    mask)."""
    rng = np.random.default_rng(4)
    sc = render_scene(0, H, W, ND)
    bgr = sc.left.astype(np.float32)
    gray = ((0.114 * bgr[..., 0] + 0.587 * bgr[..., 1] + 0.299 * bgr[..., 2]) / 255.0)
    u0 = np.clip(sc.disp_left / (ND - 1) + rng.normal(0, 0.05, (H, W)), 0, 1)
    mask = (rng.random((H, W)) < 0.2) * rng.random((H, W))
    return bgr, gray.astype(np.float32), u0.astype(np.float32), mask.astype(np.float32)


@pytest.mark.parametrize("with_mask", [False, True])
def test_diffusion_tensor(problem, with_mask):
    """Both the image tensor and the line-mask override (where mask >=
    1e-4 the mask's own gradient sets G)."""
    _, gray, _, mask = problem
    m = mask if with_mask else None
    want = jax.jit(lambda g, mm: jtgv.diffusion_tensor(g, mm))(gray, m)
    got = ttgv.diffusion_tensor(_t(gray), None if m is None else _t(m))
    assert got.shape == (H, W, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_line_response_and_support_weights(problem):
    bgr, gray, _, _ = problem
    want = jax.jit(jtgv.line_response)(gray * 255.0)
    np.testing.assert_allclose(ttgv.line_response(_t(gray * 255.0)).numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    want = jax.jit(lambda b: jnl.support_weights(b, jnl.NL2TGVParams()))(bgr / 255.0)
    got = tnl.support_weights(_t(bgr / 255.0), tnl.NL2TGVParams())
    assert got.shape == (H, W, 12)  # the causal half of the 5x5 neighbourhood
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert tnl._offsets(2) == jnl._offsets(2)


@pytest.mark.parametrize("tgv", [True, False])
def test_tgv2_refine(problem, tgv):
    """100 iterations of TGV-2 (or TV), the Lagrangian update on, with a
    line mask on the tensor."""
    _, gray, u0, mask = problem
    want = jax.jit(lambda u, g, m: jtgv.tgv2_refine(
        u, g, jtgv.TGVParams(lagrangian=True), m, tgv=tgv))(u0, gray, mask)
    got = ttgv.tgv2_refine(_t(u0), _t(gray), ttgv.TGVParams(lagrangian=True), _t(mask), tgv=tgv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert not np.array_equal(got.numpy(), u0)  # it ran


@pytest.mark.parametrize("lagrangian", [False, True])
@pytest.mark.parametrize("tgv", [True, False])
def test_nl2tgv_refine(problem, tgv, lagrangian):
    """100 iterations; the duals p (H, W, 12) and q (H, W, 12, 2)."""
    bgr, _, u0, _ = problem
    want = jax.jit(lambda u, b: jnl.nl2tgv_refine(
        u, b, jnl.NL2TGVParams(tgv=tgv, lagrangian=lagrangian)))(u0, bgr)
    got = tnl.nl2tgv_refine(_t(u0), _t(bgr), tnl.NL2TGVParams(tgv=tgv, lagrangian=lagrangian))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert not np.array_equal(got.numpy(), u0)


def test_lsd_line_mask(problem):
    """The host LSD mask (cv2): the port's equals the JAX package's, from a
    numpy array or a tensor."""
    pytest.importorskip("cv2")
    bgr = problem[0]
    gray = bgr.mean(-1)
    want = jtgv.lsd_line_mask(gray)
    np.testing.assert_array_equal(ttgv.lsd_line_mask(gray), want)
    np.testing.assert_array_equal(ttgv.lsd_line_mask(_t(gray)), want)
    assert want.dtype == np.float32 and want.max() > 0


@pytest.mark.parametrize("prior", ["2TGV", "TV", "NL2TGV", "NLTV", "NONE"])
def test_apply_smoothness(problem, prior):
    """Every prior string from the same disparity map (pixels, some outside
    [0, max_disp - 1] to exercise the clip), at 30 iterations."""
    bgr, _, u0, _ = problem
    cfg = MSTConfig(max_disp=ND, smoothness_prior=prior, smoothness_iters=30)
    disp = (u0 * 1.2 - 0.1) * (ND - 1)
    want = np.asarray(jmst._apply_smoothness(jnp.asarray(disp), bgr, cfg))
    got = tmst._apply_smoothness(_t(disp), bgr, port_cfg(cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * (ND - 1))
    if prior == "NONE":
        np.testing.assert_array_equal(got, disp)


def test_apply_smoothness_rejects_unknown_prior():
    cfg = MSTConfig(smoothness_prior="L1")
    with pytest.raises(ValueError, match="NL2TGV/NLTV/2TGV/TV/NONE, got 'L1'"):
        tmst._apply_smoothness(torch.zeros(4, 4), np.zeros((4, 4, 3), np.float32),
                               port_cfg(cfg))


@pytest.mark.parametrize("prior", ["2TGV", "NL2TGV"])
def test_mst_stereo_with_prior(prior):
    """A prior through an MST entry (mst_stereo on the host forest, the
    scene of tests/test_mst.py's prior test): both maps within 0.1 px of
    JAX's on >= 95% of pixels."""
    rng = np.random.default_rng(0)
    h, w, d = 24, 32, 8
    img = np.full((h, w, 3), 128, np.float32)
    vol = np.full((h, w, d), 0.5, np.float32)
    vol[:, :, 4] = 0.0
    vol += rng.random((h, w, d)).astype(np.float32) * 0.05
    cfg = MSTConfig(max_disp=d, iterations=15, smoothness_prior=prior, smoothness_iters=20)
    want = jmst.mst_stereo(img, img, vol, vol, cfg, seed=0, max_neighbors=2)
    got = tmst.mst_stereo(img, img, vol, vol, port_cfg(cfg), seed=0, max_neighbors=2,
                          device="cpu")
    for g, wnt in ((got.left_disp, want.left_disp), (got.right_disp, want.right_disp)):
        assert np.mean(np.abs(g.numpy() - np.asarray(wnt)) <= 0.1) >= 0.95
    base = tmst.mst_stereo(img, img, vol, vol,
                           port_cfg(dataclasses.replace(cfg, smoothness_prior="NONE")), seed=0,
                           max_neighbors=2, device="cpu")
    assert not torch.equal(got.right_disp, base.right_disp)  # the prior ran
