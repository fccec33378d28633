"""Port of the filters and the AD+gradient cost volumes against the JAX
package on the same numpy inputs.

Tolerance: rtol 1e-5. Window sums are differences of cumsum prefixes in
both packages, summed in different orders, so an absolute term of a few
float32 ulps of the largest prefix is added where a test sums raw pixel
values (`_prefix_atol`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.apps.stereo_yin import builtin_cost_volumes as j_builtin
from stereomatch_tpu.config import CostVolumeConfig
from stereomatch_tpu.ops import cost as jc
from stereomatch_tpu.ops import filters as jf
from stereomatch_tpu_torch.apps.stereo_yin import builtin_cost_volumes as t_builtin
from stereomatch_tpu_torch.ops import cost as tc
from stereomatch_tpu_torch.ops import filters as tf
from test_torch_config import port_cfg

RTOL = 1e-5


def _prefix_atol(x: np.ndarray) -> float:
    """4 float32 ulps of the largest cumsum prefix along one image axis."""
    return 4 * float(np.finfo(np.float32).eps) * float(np.abs(x).sum(axis=1).max())


@pytest.fixture
def pair(rng):
    left = (rng.random((48, 64, 3)) * 255).astype(np.float32)
    return left, np.roll(left, -3, axis=1)


@pytest.mark.parametrize("radius", [1, 2, 9])
@pytest.mark.parametrize("axis", [0, 1])
def test_box_filter_sum(pair, radius, axis):
    x = pair[0][..., 1]
    want = np.asarray(jf.box_filter_sum(jnp.asarray(x), radius, axis))
    got = tf.box_filter_sum(torch.from_numpy(x), radius, axis).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=_prefix_atol(x))


@pytest.mark.parametrize("mode", ["zero", "reflect"])
@pytest.mark.parametrize("radius", [1, 2, 9])
def test_box_filter_modes(pair, mode, radius):
    x = pair[0]
    want = np.asarray(jf.box_filter(jnp.asarray(x), radius, (0, 1), mode))
    got = tf.box_filter(torch.from_numpy(x), radius, (0, 1), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=_prefix_atol(x))


def test_median3x3_exact(pair):
    x = pair[0]
    np.testing.assert_array_equal(
        tf.median3x3(torch.from_numpy(x)).numpy(), np.asarray(jf.median3x3(jnp.asarray(x)))
    )


def test_guided_filters(pair, rng):
    g = jc.bgr_to_gray(jnp.asarray(pair[0]))
    vol = rng.random((48, 64, 20)).astype(np.float32) * 0.5
    gt = torch.from_numpy(np.array(g))
    want = np.asarray(jf.guided_filter_gray(g, jnp.asarray(vol), 9, 650.25))
    got = tf.guided_filter_gray(gt, torch.from_numpy(vol), 9, 650.25).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    # slabbed volume filter, ragged last slab (20 = 16 + 4)
    want = np.asarray(jf.guided_filter_volume(g, jnp.asarray(vol), 9, 650.25, 16))
    got = tf.guided_filter_volume(gt, torch.from_numpy(vol), 9, 650.25, 16).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("sign,min_disp", [(-1, 0), (1, 0), (-1, 3)])
def test_shifted_stack(pair, sign, min_disp):
    x = pair[0]
    ws, wv = jc.shifted_stack(jnp.asarray(x), 16, sign, min_disp)
    ts, tv = tc.shifted_stack(torch.from_numpy(x), 16, sign, min_disp)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


def test_adgrad_volumes(pair):
    left, right = pair
    cfg = CostVolumeConfig(min_disp=0, max_disp=15)
    want = jc.adgrad_bgr_volumes(jnp.asarray(left), jnp.asarray(right), cfg)
    got = tc.adgrad_bgr_volumes(torch.from_numpy(left), torch.from_numpy(right), port_cfg(cfg))
    np.testing.assert_array_equal(
        tc.bgr_to_gray(torch.from_numpy(left)).numpy(), np.asarray(jc.bgr_to_gray(jnp.asarray(left)))
    )
    for w_, g_ in zip(want, got):
        assert g_.dtype == torch.float32 and g_.shape == (48, 64, 16)
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("guided", [True, False])
def test_builtin_cost_volumes(pair, guided):
    left, right = pair
    want = j_builtin(left, right, 16, guided=guided)
    got = t_builtin(torch.from_numpy(left), torch.from_numpy(right), 16, guided=guided)
    for w_, g_ in zip(want, got):
        assert float(g_.max()) <= 0.5
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=RTOL, atol=1e-6)
