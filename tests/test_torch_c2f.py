"""The port's coarse-to-fine 3DMST (models/mst.py::mst_stereo_c2f) against
the JAX package, on the CPU, on tests/test_mst.py's slanted plane with a
step (48x80, 16 disparity slices, host forest).

c2f runs random init at the coarse scale, and the port's init_labels is
not bit-exact with JAX's (XLA's CPU cos / sin / sqrt ulps, ROADMAP queue
3), so the whole frame is held by share of pixels, as the flat frame is
(tests/test_torch_mst_flat.py): within 0.1 px on >= 95% (measured: 100%,
at most 1.1e-5 px apart, with and without 2TGV). The fine stage alone,
from JAX's own coarse labels, is held tightly: within 1e-4 px on >= 99%
of pixels (measured: 100%).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.config import MSTConfig
from stereomatch_tpu.models import mst as jmodels
from stereomatch_tpu.ops import mst as jmst
from stereomatch_tpu_torch.interop import key_from_jax
from stereomatch_tpu_torch.models import mst as tmodels
from test_torch_config import port_cfg

H, W, D = 48, 80, 16
CFG = MSTConfig(max_disp=D, iterations=40, min_cc_size=50, c=2000.0, smoothness_iters=20)
RUN = dict(seed=0, k=2, coarse_iterations=30, fine_iterations=10, max_neighbors=4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """tests/test_mst.py::test_mst_coarse_to_fine_converges's scene: (image,
    volume, true disparity)."""
    rng = np.random.default_rng(0)
    xs = np.arange(W, dtype=np.float32)[None, :]
    d_true = 0.1 * xs + 3.0 + np.zeros((H, 1), np.float32)
    d_true[:, W // 2:] += 4.0
    ds = np.arange(D, dtype=np.float32)[None, None, :]
    vol = np.minimum(np.abs(ds - d_true[..., None]) * 0.15, 0.5).astype(np.float32)
    vol += rng.random((H, W, D)).astype(np.float32) * 0.1
    img = np.full((H, W, 3), 100.0, np.float32)
    img[:, W // 2:] = 180.0
    return img, vol, d_true


def _share(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.mean(np.abs(got - want) <= tol)


@pytest.mark.parametrize("prior", ["NONE", "2TGV"])
def test_mst_stereo_c2f_vs_jax(scene, prior):
    img, vol, d_true = scene
    cfg = dataclasses.replace(CFG, smoothness_prior=prior)
    want = jmodels.mst_stereo_c2f(img, img, vol, vol, cfg, **RUN)
    got = tmodels.mst_stereo_c2f(img, img, vol, vol, port_cfg(cfg), **RUN, device="cpu")
    assert _share(got.left_disp, want.left_disp, 0.1) >= 0.95
    assert _share(got.right_disp, want.right_disp, 0.1) >= 0.95
    assert np.mean(got.left_valid.numpy() == np.asarray(want.left_valid)) >= 0.95
    # and it recovers the scene, as the JAX test demands of its own
    err = np.abs(got.right_disp.numpy() - d_true)[4:-4, 4:-4]
    assert (err > 1.0).mean() < 0.02 and err.mean() < 0.5


def test_c2f_fine_stage_from_jax_coarse_labels(scene):
    """The full-scale stage (rescaled seed, its aggregated cost, 10
    iterations) from the coarse pixel maps and the fine key JAX's c2f
    makes for the left view."""
    img, vol, _ = scene
    k, dc = 2, D // 2
    kl = jax.random.split(jax.random.PRNGKey(0))[0]
    kc, kf = jax.random.split(kl)
    cfg_c = dataclasses.replace(CFG, max_disp=dc, iterations=30)
    fa_c = jmodels.build_view_forest(img[::k, ::k], cfg_c)
    labels = jmst.mst_pms_optimize(kc, jnp.asarray(vol)[::k, ::k, ::k][:, :, :dc], fa_c, cfg_c,
                                   max_neighbors=4)[:3]
    hc, wc = H // k, W // k
    maps = [jnp.zeros(hc * wc).at[fa_c.pixel_of_node].set(v).reshape(hc, wc) for v in labels]

    fa = jmodels.build_view_forest(img, CFG)
    pix = fa.pixel_of_node
    ys, xs = jnp.clip((pix // W) // k, 0, hc - 1), jnp.clip((pix % W) // k, 0, wc - 1)
    a0, b0, c0 = maps[0][ys, xs], maps[1][ys, xs], maps[2][ys, xs] * float(k)
    mc0 = jmodels._seed_min_cost(jnp.asarray(vol), a0, b0, c0, fa, CFG)
    a, b, c, _ = jmst.mst_pms_optimize(kf, jnp.asarray(vol), fa, CFG, max_neighbors=4,
                                       iterations=10, init_state=(a0, b0, c0, mc0))
    want = jmst.labels_to_disparity(a, b, c, fa, D) * (D - 1.0)

    got = tmodels._c2f_fine(key_from_jax(kf, "cpu"), img, torch.from_numpy(vol),
                            port_cfg(CFG), k, [torch.from_numpy(np.array(m)) for m in maps],
                            10, 4, "cpu")
    assert _share(got, want, 1e-4) >= 0.99


def test_c2f_coarse_maps_scatter_every_pixel(scene):
    """The coarse stage's labels land on every coarse pixel, as the JAX
    .at[].set does (pixel_of_node is a permutation)."""
    img, vol, _ = scene
    cfg_c = port_cfg(dataclasses.replace(CFG, max_disp=D // 2, iterations=2))
    from stereomatch_tpu_torch import random as trandom

    maps = tmodels._c2f_coarse(trandom.PRNGKey(0, "cpu"), torch.from_numpy(img[::2, ::2]),
                               torch.from_numpy(vol[::2, ::2, ::2]), cfg_c, 4, "cpu")
    assert all(m.shape == (H // 2, W // 2) for m in maps)
    assert (maps[2] != 0).float().mean() > 0.99  # every pixel written (c is rarely exactly 0)


def test_c2f_falls_back_to_flat_below_2k_slices():
    """max_disp < 2k: too few coarse slices, so the flat mst_stereo runs
    coarse + fine iterations, as in JAX."""
    rng = np.random.default_rng(1)
    h, w, d = 16, 24, 3
    img = np.full((h, w, 3), 90.0, np.float32)
    img[:, w // 2:] = 160.0
    d_true = np.where(np.arange(w) < w // 2, 0.5, 1.5)[None, :] + 0.02 * np.arange(h)[:, None]
    vol = np.minimum(np.abs(np.arange(d)[None, None, :] - d_true[..., None]) * 0.3, 0.5)
    vol = (vol + rng.random((h, w, d)) * 0.05).astype(np.float32)
    cfg = MSTConfig(max_disp=d, iterations=4, min_cc_size=10, c=500.0)
    want = jmodels.mst_stereo_c2f(img, img, vol, vol, cfg, seed=3, k=2, max_neighbors=2)
    got = tmodels.mst_stereo_c2f(img, img, vol, vol, port_cfg(cfg), seed=3, k=2,
                                 max_neighbors=2, device="cpu")
    flat = tmodels.mst_stereo(img, img, vol, vol,
                              port_cfg(dataclasses.replace(cfg, iterations=5)), seed=3,
                              max_neighbors=2, device="cpu")
    assert torch.equal(got.left_disp, flat.left_disp)
    assert torch.equal(got.right_disp, flat.right_disp)
    assert _share(got.right_disp, want.right_disp, 0.1) >= 0.95
