"""The port's classical-engine ops against the JAX package on the same numpy
inputs: census, BM, speckle, WTA, the LR checks, the variational denoise,
the colour guided filter, local contrast, the windowed volumes and the
segmentation. No function here reaches a Pallas kernel.

Exact where the arithmetic is: census Hamming volumes are integers, BM's
SAD of integer-valued images is an integer below 2^24 (every box sum
exact), and speckle labels, WTA, the LR masks and the segmentation are
selections and integer label propagation. Elsewhere the tolerances were
set from measurement (max |diff| measured, then about 10x):
  - huber / variational denoise, 100 iterations: 2.9e-5 px on a 0-60
    range -> atol 2e-4 px;
  - guided_filter_color: 9e-7 on outputs up to 0.7 -> atol 1e-5;
  - local_contrast: 3.1e-5 on [0, 255] gray -> atol 3e-4;
  - windowed volumes, cumsum box sums of products summed in another
    order: zncc 1.4e-6 (atol 1e-5), ad 6.1e-4 and agd 1.7e-4 on window
    sums up to 567 -> rtol 1e-5 plus atol 5e-3.

The JAX package runs these ops eagerly, one XLA program per op and shape.
Where a pipeline test in test_torch_classic_pipelines.py runs the same
eager ops at the same (H, W, D), so do the tests here and the programs are
compiled once; elsewhere `ref` compiles the JAX function whole.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.config import BMConfig, CensusConfig, DenoiseConfig, ZNCCConfig
from stereomatch_tpu.ops import bm as jbm
from stereomatch_tpu.ops import cost as jcost
from stereomatch_tpu.ops import filters as jf
from stereomatch_tpu.ops import postprocess as jpp
from stereomatch_tpu.ops import segmentation as jseg
from stereomatch_tpu.ops import select as jsel
from stereomatch_tpu.ops import speckle as jsp
from stereomatch_tpu.ops import variational as jvar
from stereomatch_tpu_torch.ops import bm as tbm
from stereomatch_tpu_torch.ops import cost as tcost
from stereomatch_tpu_torch.ops import filters as tf
from stereomatch_tpu_torch.ops import postprocess as tpp
from stereomatch_tpu_torch.ops import segmentation as tseg
from stereomatch_tpu_torch.ops import select as tsel
from stereomatch_tpu_torch.ops import speckle as tsp
from stereomatch_tpu_torch.ops import variational as tvar
from stereomatch_tpu_torch.synthetic import render_scene
from test_torch_config import port_cfg

H, W, D = 48, 64, 16  # the pipeline tests' scene


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def ref(fn, *arrays, eager=False):
    """JAX's `fn` on numpy arrays: compiled whole, or op by op as the JAX
    package's pipelines run it (`eager`, for shapes a pipeline test shares)."""
    args = [jnp.asarray(a) for a in arrays]
    return fn(*args) if eager else jax.jit(fn)(*args)


@pytest.fixture(scope="module")
def scene():
    return render_scene(0, H, W, D)


@pytest.fixture(scope="module")
def gray(scene):
    """(left, right) gray of the scene: float and rounded to integers."""
    gl = scene.left.mean(-1).astype(np.float32)
    gr = scene.right.mean(-1).astype(np.float32)
    return gl, gr, np.round(gl), np.round(gr)


@pytest.mark.parametrize("cfg", [CensusConfig(d_max=D - 1), CensusConfig(win_rw=2, win_rh=3, d_max=9)],
                         ids=["9x17", "5x7"])
def test_census_bit_equal(gray, cfg):
    """Both Hamming volumes and the WTA disparity, bit for bit."""
    l, r = gray[0] / 255.0, gray[1] / 255.0
    eager = cfg.d_max == D - 1  # the census pipeline's
    want = ref(lambda a, b: jcost.census_cost_volumes(a, b, cfg), l, r, eager=eager)
    got = tcost.census_cost_volumes(T(l), T(r), port_cfg(cfg))
    for w_, g_ in zip(want, got):
        assert g_.dtype == torch.int32 and g_.shape == (H, W, cfg.d_max + 1)
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    want = np.asarray(ref(lambda a, b: jcost.census_stereo(a, b, cfg), l, r, eager=eager))
    got = tcost.census_stereo(T(l), T(r), port_cfg(cfg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_popcount_swar(rng):
    """The masked SWAR popcount on words of up to 63 bits."""
    words = rng.integers(0, 2**63, 4000, dtype=np.int64)
    words[:3] = (0, 2**63 - 1, 1 << 62)
    want = np.array([bin(int(x)).count("1") for x in words])
    np.testing.assert_array_equal(tcost._popcount63(T(words)).numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(uniqueness_ratio=0),
    dict(disp12_max_diff=-1),
    dict(min_disp=2, block_size=5),
    dict(roi1=(2, 3, 50, 40), roi2=(0, 1, 60, 44)),
], ids=["default", "no-uniqueness", "no-disp12", "min-disp", "roi"])
def test_bm_bit_equal_on_integer_gray(gray, kw):
    cfg = BMConfig(num_disp=D, **kw)
    eager = cfg.block_size == 9 and cfg.min_disp == 0  # the BM pipeline's
    want = ref(lambda a, b: jbm.bm_disparity(a, b, cfg), gray[2], gray[3], eager=eager)
    got = tbm.bm_disparity(T(gray[2]), T(gray[3]), port_cfg(cfg))
    np.testing.assert_array_equal(got.disparity.numpy(), np.asarray(want.disparity))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.float().mean() > 0.25
    assert tbm.valid_disparity_roi((2, 3, 50, 40), (0, 1, 60, 44), 0, 16, 9) == \
        jbm.valid_disparity_roi((2, 3, 50, 40), (0, 1, 60, 44), 0, 16, 9)


def test_bm_float_luma_differs_only_in_the_last_bits(gray):
    """On float gray the SAD box sums round in another order: measured on
    this scene, the valid masks and the integer WTA agree on every pixel,
    the subpixel disparities within 1e-6 px, and 83% of the maps bit for
    bit."""
    cfg = BMConfig(num_disp=D)
    want = jbm.bm_disparity(jnp.asarray(gray[0]), jnp.asarray(gray[1]), cfg)
    got = tbm.bm_disparity(T(gray[0]), T(gray[1]), port_cfg(cfg))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    dw, dg = np.asarray(want.disparity), got.disparity.numpy()
    np.testing.assert_array_equal(np.round(dg), np.round(dw))
    np.testing.assert_allclose(dg, dw, rtol=0, atol=1e-5)
    assert (dg == dw).mean() > 0.75


@pytest.mark.parametrize("max_size", [3, 20])
def test_speckle_bit_equal_on_jax_bm_map(gray, max_size):
    """filter_speckles, and its components and sizes, on JAX's own BM map."""
    d = np.asarray(jbm.bm_disparity(jnp.asarray(gray[2]), jnp.asarray(gray[3]),
                                    BMConfig(num_disp=D)).disparity)
    valid = d != -1.0
    cr = (np.abs(np.diff(d, axis=1)) <= 1.0) & valid[:, 1:] & valid[:, :-1]
    cd = (np.abs(np.diff(d, axis=0)) <= 1.0) & valid[1:] & valid[:-1]
    want_lab = np.asarray(jsp.connected_components(jnp.asarray(cr), jnp.asarray(cd)))
    got_lab = tsp.connected_components(T(cr), T(cd))
    np.testing.assert_array_equal(got_lab.numpy(), want_lab)
    np.testing.assert_array_equal(tsp.component_sizes(got_lab).numpy(),
                                  np.asarray(jsp.component_sizes(jnp.asarray(want_lab))))
    want = np.asarray(jsp.filter_speckles(jnp.asarray(d), -1.0, max_size, 1.0))
    got = tsp.filter_speckles(T(d), -1.0, max_size, 1.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != d).any() == (max_size == 20)


def test_connected_components_partial_rounds(rng):
    """One, two and 16 rounds on a random graph: the labels mid-propagation,
    where each read must see the state JAX's read sees."""
    cr = rng.random((H, W - 1)) > 0.3
    cd = rng.random((H - 1, W)) > 0.3
    for iters in (1, 2, 16):
        np.testing.assert_array_equal(
            tsp.connected_components(T(cr), T(cd), iters).numpy(),
            np.asarray(jsp.connected_components(jnp.asarray(cr), jnp.asarray(cd), iters)))


@pytest.fixture
def volume(rng):
    """An (H, W, D) volume with ties, minima at both ends and flat rows
    (zero curvature)."""
    vol = rng.random((H, W, D)).astype(np.float32)
    vol[0] = 0.5
    vol[1, :, 0] = -1.0
    vol[2, :, -1] = -1.0
    vol[3, :, 4:7] = -2.0
    return vol


@pytest.mark.parametrize("min_disp,subpixel", [(0, True), (3, True), (3, False)])
def test_wta_equal(volume, min_disp, subpixel):
    want = np.asarray(jsel.wta_disparity(jnp.asarray(volume), min_disp, subpixel))
    got = tsel.wta_disparity(T(volume), min_disp, subpixel).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsel.wta_argmin(T(volume)).numpy(),
                                  np.asarray(jsel.wta_argmin(jnp.asarray(volume))))


def test_wta_coupled_equal(volume, rng):
    u = (rng.random((H, W)) * D).astype(np.float32)
    lagr = rng.random((H, W)).astype(np.float32)
    want = np.asarray(jsel.wta_coupled(jnp.asarray(volume), jnp.asarray(u), jnp.asarray(lagr),
                                       1.5, 0.3, 2))
    got = tsel.wta_coupled(T(volume), T(u), T(lagr), 1.5, 0.3, 2).numpy()
    np.testing.assert_array_equal(got, want)


def _lr_maps(rng):
    dl = (rng.random((H, W)) * D).astype(np.float32)
    dr = (rng.random((H, W)) * D).astype(np.float32)
    dl[:, ::4] = 2.5  # x.5 disparities: half to even (2), not away (3)
    dl[:, 1::4] = 3.5  # and 4
    dr[:, 2::4] = 0.5
    dr[5] = dl[5]  # a consistent-looking row
    return dl, dr


@pytest.mark.parametrize("sign", [-1, 1])
def test_lr_occlusion_mask_equal(rng, sign):
    dl, dr = _lr_maps(rng)
    for args in ((D - 1.0, 0.0), (10.0, 1.0), (D - 1.0, 0.0, 0.5)):
        want = np.asarray(jpp.lr_occlusion_mask(jnp.asarray(dl), jnp.asarray(dr), sign, *args))
        got = tpp.lr_occlusion_mask(T(dl), T(dr), sign, *args).numpy()
        np.testing.assert_array_equal(got, want)


def test_lr_check_fill_pair_equal(rng):
    dl, dr = _lr_maps(rng)
    want = jpp.lr_check_fill_pair(jnp.asarray(dl), jnp.asarray(dr), D - 1.0, 0.0)
    got = tpp.lr_check_fill_pair(T(dl), T(dr), D - 1.0, 0.0)
    for w_, g_ in zip(want, got):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


def test_huber_and_variational_denoise(rng):
    """100 iterations (the default), dual then primal, as JAX's fori_loop."""
    f = rng.random((H, W)).astype(np.float32)
    g = (rng.random((H, W)) * 255).astype(np.float32)
    w = np.asarray(jvar.edge_weight(jnp.asarray(g)))
    np.testing.assert_allclose(tvar.edge_weight(T(g)).numpy(), w, rtol=1e-6, atol=1e-7)
    want = np.asarray(jvar.huber_denoise(jnp.asarray(f), jnp.asarray(w)))
    got = tvar.huber_denoise(T(f), T(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 / 60)
    want = np.asarray(jvar.variational_disparity_denoise(jnp.asarray(f * 60), jnp.asarray(g), 0, 60))
    got = tvar.variational_disparity_denoise(T(f * 60), T(g), 0, 60).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    cfg = DenoiseConfig(iterations=7, lam=0.8, alpha=4.0, beta=2.0)
    want = np.asarray(ref(lambda a, b: jvar.variational_disparity_denoise(a, b, 2, 60, cfg), f * 60, g))
    got = tvar.variational_disparity_denoise(T(f * 60), T(g), 2, 60, port_cfg(cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("k", [0, 5])
def test_guided_filter_color(rng, k):
    img = (rng.random((40, 50, 3)) * 255).astype(np.float32)
    src = rng.random((40, 50, k) if k else (40, 50)).astype(np.float32)
    want = np.asarray(ref(lambda i, s: jf.guided_filter_color(i, s, 4, 650.25), img, src))
    got = tf.guided_filter_color(T(img), T(src), 4, 650.25).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_local_contrast(rng):
    g = (rng.random((40, 50)) * 255).astype(np.float32)
    want = np.asarray(ref(lambda x: jcost.local_contrast(x, 17), g))
    np.testing.assert_allclose(tcost.local_contrast(T(g), 17).numpy(), want, rtol=0, atol=3e-4)


@pytest.mark.parametrize("metric,atol", [("zncc", 1e-5), ("ad", 5e-3), ("agd", 5e-3)])
def test_windowed_volumes(rng, metric, atol):
    g = (rng.random((40, 50)) * 255).astype(np.float32)
    g2 = np.roll(g, -3, axis=1)
    cfg = ZNCCConfig(min_disp=1, max_disp=11, metric=metric)
    want = ref(lambda a, b: jcost.windowed_volumes(a, b, cfg), g, g2)
    got = tcost.windowed_volumes(T(g), T(g2), port_cfg(cfg))
    for w_, g_ in zip(want, got):
        assert g_.dtype == torch.float32 and g_.shape == (40, 50, 11)
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("c,min_size", [(800.0, 20), (5000.0, 200)])
def test_segment_image_equal(scene, c, min_size):
    want = np.asarray(jseg.segment_image(scene.left, c, min_size))
    got = tseg.segment_image(scene.left, c, min_size, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1
