"""The port's segmentation and device forest (ops/segmentation.py,
ops/device_forest.py) against the JAX package: every integer array of
`build_forest_device` equal, float arrays within 1e-6 (w_exp goes
through exp, whose last bit differs between libraries; rel_gd is summed in
the JAX doubling order and compares equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.config import production_mst_config
from stereomatch_tpu.models.sgbm_mst import _view_forest as j_view_forest
from stereomatch_tpu.ops.device_forest import build_forest_device as j_build
from stereomatch_tpu.ops.segmentation import boruvka_segment as j_segment
from stereomatch_tpu_torch.models.mst import _fused_capacities
from stereomatch_tpu_torch.models.sgbm_mst import _view_forest as t_view_forest
from stereomatch_tpu_torch.ops.device_forest import build_forest_device as t_build
from stereomatch_tpu_torch.ops.device_forest import device_forest_arrays
from stereomatch_tpu_torch.ops.segmentation import boruvka_segment as t_segment
from test_torch_config import port_cfg

CASES = [(48, 64, 800.0, 20), (31, 45, 300.0, 4), (96, 128, 2000.0, 100)]


def _weights(rng, h, w):
    img = np.round(rng.random((h, w, 3)) * 255).astype(np.float32)
    for _ in range(2):
        img = np.round((img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3)
    wr = np.abs(img[:, 1:] - img[:, :-1]).sum(-1).astype(np.float32)
    wd = np.abs(img[1:] - img[:-1]).sum(-1).astype(np.float32)
    return wr, wd


def _assert_forest_equal(want: dict, got: dict):
    for k, v in got.items():
        a, b = np.asarray(want[k]), v.cpu().numpy()
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(b.astype(np.int64), a.astype(np.int64), err_msg=k)


@pytest.mark.parametrize("h,w,c,min_size", CASES)
def test_boruvka_segment_exact(rng, h, w, c, min_size):
    wr, wd = _weights(rng, h, w)
    want = np.asarray(j_segment(jnp.asarray(wr), jnp.asarray(wd), c, min_size))
    got = t_segment(torch.from_numpy(wr), torch.from_numpy(wd), c, min_size).numpy()
    np.testing.assert_array_equal(got, want)
    assert 1 < len(np.unique(got)) < h * w


@pytest.mark.parametrize("h,w,c,min_size", CASES)
@pytest.mark.parametrize("delta", [4.0, 1.0])
def test_build_forest_device_exact(rng, h, w, c, min_size, delta):
    """delta=1 cuts segments often, exercising cut children and carries."""
    wr, wd = _weights(rng, h, w)
    tmax = 1 << max(1, max(256, 4 * h * w // min_size) - 1).bit_length()
    kw = dict(c=c, min_size=min_size, delta=delta, tmax=tmax, adj_cap=8 * tmax)
    want = j_build(jnp.asarray(wr), jnp.asarray(wd), **kw)
    got = t_build(torch.from_numpy(wr), torch.from_numpy(wd), **kw)
    _assert_forest_equal(want, got)
    assert int(got["seg_root"].sum()) > int(got["num_trees_actual"])  # real cuts


def test_view_forest_float_image(rng):
    """The production forest of a float BGR frame (median prefilter + L1
    colour weights): integer structure equal to JAX."""
    img = (rng.random((48, 64, 3)) * 255).astype(np.float32)
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    cfg = production_mst_config(16, on_tpu=False, min_cc_size=20, c=800.0)
    tmax, adj_cap = _fused_capacities(48, 64, cfg)
    want = j_view_forest(jnp.asarray(img), cfg, tmax, adj_cap)
    got = t_view_forest(torch.from_numpy(img), port_cfg(cfg), tmax, adj_cap)
    _assert_forest_equal(want, got)


def test_forest_capacity_is_checked(rng):
    """More trees than tmax raises instead of clamping tree ids."""
    wr, wd = _weights(rng, 31, 45)
    raw = t_build(torch.from_numpy(wr), torch.from_numpy(wd), c=300.0, min_size=4,
                  tmax=8, adj_cap=64)
    assert int(raw["num_trees_actual"]) > 8
    with pytest.raises(ValueError, match="tmax=8"):
        device_forest_arrays(raw, 31, 45, 8)
