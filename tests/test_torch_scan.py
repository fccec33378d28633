"""The ancestor sum that kernel K2 fuses (`ops/mst_scan_cuda.py::
ancestor_sums`, whose CPU path is its plain twin) against the JAX
package's `_ancestor_sums` through both of its scans, on forests that each
package builds from the same edge weights; the Euler structure the fused
kernel relies on; and the tree filter on those forests.

Tolerances are the JAX package's own: scans rtol 1e-5 / atol 1e-4
(tests/test_mst_pallas.py, same 256-element blocking, other summation
order), tree_filter 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.config import production_mst_config
from stereomatch_tpu.ops import mst as jmst
from stereomatch_tpu.ops.device_forest import build_forest_device as j_build
from stereomatch_tpu.ops.device_forest import device_forest_arrays as j_arrays
from stereomatch_tpu.ops.mst_scan_pallas import segmented_cumsum_pallas
from stereomatch_tpu_torch.models.mst import _fused_capacities
from stereomatch_tpu_torch.models.sgbm_mst import _view_forest
from stereomatch_tpu_torch.ops import mst as tmst
from stereomatch_tpu_torch.ops.device_forest import build_forest_device as t_build
from stereomatch_tpu_torch.ops.device_forest import device_forest_arrays as t_arrays
from stereomatch_tpu_torch.ops.mst_scan_cuda import ancestor_sums, ancestor_sums_twin
from stereomatch_tpu_torch.synthetic import render_scene
from test_torch_config import port_cfg
from test_torch_forest import _weights

# (h, w, c, min_size, delta); delta=1 cuts segments often
CASES = [(48, 64, 800.0, 20, 4.0), (31, 45, 300.0, 4, 1.0), (96, 128, 2000.0, 100, 4.0)]


def _forests(rng, h, w, c, min_size, delta):
    """ForestArrays of the same weights, built by the JAX package and by
    the port."""
    wr, wd = _weights(rng, h, w)
    tmax = 1 << max(1, max(256, 4 * h * w // min_size) - 1).bit_length()
    kw = dict(c=c, min_size=min_size, delta=delta, tmax=tmax, adj_cap=8 * tmax)
    fj = j_arrays(j_build(jnp.asarray(wr), jnp.asarray(wd), **kw), h, w, tmax)
    ft = t_arrays(t_build(torch.from_numpy(wr), torch.from_numpy(wd), **kw), h, w, tmax)
    return fj, ft


def _jax_scan(fj, scan):
    if scan == "pallas":  # as the JAX package's own tests run the kernel off the TPU
        return lambda x: segmented_cumsum_pallas(x, fj.escan_pk, interpret=True)
    return lambda x: jmst._segmented_cumsum_mm(x, fj.escan)


@pytest.mark.parametrize("case,scan", [(c, "xla") for c in CASES] + [(c, "pallas") for c in CASES[:2]])
def test_ancestor_sums_twin_vs_jax(rng, case, scan):
    fj, ft = _forests(rng, *case)
    n = case[0] * case[1]
    v = (rng.random((7, n)) - 0.3).astype(np.float32)
    want = np.asarray(jmst._ancestor_sums(jnp.asarray(v), fj, _jax_scan(fj, scan)))
    before = ancestor_sums.launches
    got = ancestor_sums(torch.from_numpy(v), ft.euler_src, ft.euler_is_in, ft.euler_reset,
                        ft.in_pos)
    assert ancestor_sums.launches == before  # a CPU tensor runs the twin
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # the tree filter's _ancestor_sums is this function; one row too
    np.testing.assert_array_equal(tmst._ancestor_sums(torch.from_numpy(v), ft).numpy(), got.numpy())
    one = ancestor_sums_twin(torch.from_numpy(v[3]), ft.euler_src, ft.euler_is_in,
                             ft.euler_reset, ft.in_pos)
    np.testing.assert_array_equal(one.numpy(), got[3].numpy())


def _assert_in_events_cover_nodes(f):
    """What the fused kernel's stores rely on: each in-event j holds
    in_pos[euler_src[j]] == j, and the in-events hold every node once."""
    j = torch.nonzero(f.euler_is_in).squeeze(1)
    n = f.in_pos.shape[0]
    assert f.euler_src.shape == (2 * n,) and j.shape == (n,)
    assert torch.equal(f.in_pos[f.euler_src[j]], j)
    assert torch.equal(torch.sort(f.euler_src[j]).values, torch.arange(n))
    assert bool(f.euler_reset[0]) and bool(f.euler_is_in[0])


@pytest.mark.parametrize("case", CASES)
def test_in_events_are_in_pos(rng, case):
    fj, ft = _forests(rng, *case)
    _assert_in_events_cover_nodes(ft)
    # the same positions in the JAX forest
    np.testing.assert_array_equal(ft.in_pos.numpy(), np.asarray(fj.in_pos))
    np.testing.assert_array_equal(ft.euler_src.numpy(), np.asarray(fj.euler_src))


def test_in_events_are_in_pos_view_forest():
    """The production forest of a rendered frame (median prefilter, colour
    weights, band cuts), as the servers build it."""
    h, w, d = 60, 90, 24
    scene = render_scene(3, h, w, d)
    cfg = port_cfg(production_mst_config(d, on_tpu=False, min_cc_size=40, c=1000.0,
                                         forest_backend="device"))
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    raw = _view_forest(torch.from_numpy(scene.left), cfg, tmax, adj_cap)
    f = t_arrays(raw, h, w, tmax)
    _assert_in_events_cover_nodes(f)
    assert int(f.seg_root.sum()) > 1


@pytest.mark.parametrize("carry_iters", [1, 2])
@pytest.mark.parametrize("case", CASES[:2])
def test_tree_filter_both_builders(rng, case, carry_iters):
    """tree_filter with the fused ancestor sum's twin against JAX's, each
    on its own package's forest, as test_tree_filter_shared_forest holds
    it on one shared forest."""
    fj, ft = _forests(rng, *case)
    n = case[0] * case[1]
    cost = (rng.random((7, n)) * 0.5).astype(np.float32)
    want = np.asarray(jmst.tree_filter(jnp.asarray(cost), fj, carry_iters))
    got = tmst.tree_filter(torch.from_numpy(cost), ft, carry_iters).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    inv_j = np.asarray(jmst.aggregation_norm_inv(fj, carry_iters))
    inv_t = tmst.aggregation_norm_inv(ft, carry_iters).numpy()
    np.testing.assert_allclose(inv_t, inv_j, rtol=1e-4, atol=1e-4)


def test_ancestor_sums_device_dispatch(rng):
    """A CPU tensor takes the twin; a tensor on any other non-CUDA device
    raises instead of falling back."""
    _, ft = _forests(rng, *CASES[1])
    v = torch.rand(2, ft.in_pos.shape[0])
    before = ancestor_sums.launches
    ancestor_sums(v, ft.euler_src, ft.euler_is_in, ft.euler_reset, ft.in_pos)
    assert ancestor_sums.launches == before
    meta = [t.to("meta") for t in (v, ft.euler_src, ft.euler_is_in, ft.euler_reset, ft.in_pos)]
    with pytest.raises(ValueError, match="CUDA"):
        ancestor_sums(*meta)
