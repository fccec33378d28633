"""The port's segmented scan (K2's twin), tree filter and seeded label
optimization against the JAX package, on one shared forest and key
(`interop.forest_from_numpy`, `interop.key_from_jax`).

Tolerances are the JAX package's own: scans rtol 1e-5 / atol 1e-4
(tests/test_mst_pallas.py, same 256-element blocking, other summation
order), tree_filter 1e-4, min cost after optimization 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.config import production_mst_config
from stereomatch_tpu.models.mst import _seed_min_cost as j_seed_min_cost
from stereomatch_tpu.ops import mst as jmst
from stereomatch_tpu.ops.device_forest import build_forest_device, device_forest_arrays
from stereomatch_tpu.ops.mst_scan_pallas import build_packed_scan_maps, segmented_cumsum_pallas
from stereomatch_tpu_torch.interop import forest_from_numpy, key_from_jax
from stereomatch_tpu_torch.models.mst import _seed_min_cost as t_seed_min_cost
from stereomatch_tpu_torch.ops import mst as tmst
from stereomatch_tpu_torch.ops.mst_scan_cuda import segmented_cumsum, segmented_cumsum_twin
from test_torch_config import port_cfg


def _random_reset(rng, m, mean_seg):
    reset = rng.random(m) < 1.0 / mean_seg
    reset[0] = True
    return reset


@pytest.mark.parametrize(
    "m,mean_seg,batch",
    [(1000, 7, ()), (4096, 900, (3,)), (700, 40, (13,)), (256, 256, (2, 2)), (5000, 3000, (7,))],
)
def test_scan_twin_vs_jax_scans(rng, m, mean_seg, batch):
    reset = _random_reset(rng, m, mean_seg)
    x = (rng.random(batch + (m,)) - 0.3).astype(np.float32)
    got = segmented_cumsum(torch.from_numpy(x), torch.from_numpy(reset)).numpy()
    assert got.shape == x.shape
    mm = np.asarray(jmst._segmented_cumsum_mm(jnp.asarray(x), jmst._make_scan_maps(reset)))
    pal = np.asarray(segmented_cumsum_pallas(
        jnp.asarray(x), jnp.asarray(build_packed_scan_maps(reset)), interpret=True))
    np.testing.assert_allclose(got, mm, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-4)


def test_scan_twin_oracle(rng):
    m = 2000
    reset = _random_reset(rng, m, 23)
    x = (rng.random((2, m)) - 0.5).astype(np.float32)
    seg = np.cumsum(reset) - 1
    want = np.empty_like(x, np.float64)
    for s in range(seg.max() + 1):
        want[:, seg == s] = np.cumsum(x[:, seg == s].astype(np.float64), axis=1)
    got = segmented_cumsum_twin(torch.from_numpy(x), torch.from_numpy(reset.astype(np.uint8)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _shared_forest(rng, h=48, w=64, delta=4.0, c=800.0, min_size=20):
    img = np.round(rng.random((h, w, 3)) * 255).astype(np.float32)
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    wr = np.abs(img[:, 1:] - img[:, :-1]).sum(-1)
    wd = np.abs(img[1:] - img[:-1]).sum(-1)
    tmax = 1024
    raw = build_forest_device(jnp.asarray(wr), jnp.asarray(wd), c=c, min_size=min_size,
                              delta=delta, tmax=tmax, adj_cap=8 * tmax)
    fj = device_forest_arrays(raw, h, w, tmax)
    ft = forest_from_numpy({k: np.asarray(v) for k, v in raw.items()
                            if not isinstance(v, tuple)}, h, w, tmax, "cpu")
    return fj, ft


@pytest.mark.parametrize("delta", [4.0, 1.0])
@pytest.mark.parametrize("carry_iters", [1, 2])
def test_tree_filter_shared_forest(rng, delta, carry_iters):
    fj, ft = _shared_forest(rng, delta=delta)
    cost = (rng.random((7, 48 * 64)) * 0.5).astype(np.float32)
    want = np.asarray(jmst.tree_filter(jnp.asarray(cost), fj, carry_iters))
    got = tmst.tree_filter(torch.from_numpy(cost), ft, carry_iters).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    inv_j = np.asarray(jmst.aggregation_norm_inv(fj, carry_iters))
    inv_t = tmst.aggregation_norm_inv(ft, carry_iters).numpy()
    np.testing.assert_allclose(inv_t, inv_j, rtol=1e-4, atol=1e-4)


def _labels(rng, n, d):
    a = (rng.random(n).astype(np.float32) - 0.5) * 0.2
    b = (rng.random(n).astype(np.float32) - 0.5) * 0.2
    c = rng.random(n).astype(np.float32) * (d + 6) - 3  # some out of range
    return a, b, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_label_cost_and_labels(rng, dtype):
    fj, ft = _shared_forest(rng)
    d = 16
    vol = (rng.random((48, 64, d)) * 0.5).astype(np.float32)
    a, b, c = _labels(rng, 48 * 64, d)
    jv = jnp.asarray(vol).astype(dtype)
    tv = torch.from_numpy(vol).to(getattr(torch, dtype))
    want = np.asarray(jmst.label_cost(jv, jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), fj, d))
    got = tmst.label_cost(tv, *(torch.from_numpy(x) for x in (a, b, c)), ft, d).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # node-order rows give the same costs
    vn = tv.reshape(-1, d)[ft.pixel_of_node]
    got_n = tmst.label_cost(vn, *(torch.from_numpy(x) for x in (a, b, c)), ft, d,
                            vol_in_node_order=True).numpy()
    np.testing.assert_array_equal(got_n, got)
    want = np.asarray(jmst.labels_to_disparity(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), fj, d))
    got = tmst.labels_to_disparity(*(torch.from_numpy(x) for x in (a, b, c)), ft, d).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_plane_labels_from_disparity(rng):
    fj, ft = _shared_forest(rng)
    disp = (rng.random((48, 64)) * 15).astype(np.float32)
    want = jmst.plane_labels_from_disparity(jnp.asarray(disp), fj)
    got = tmst.plane_labels_from_disparity(torch.from_numpy(disp), ft)
    # the box smoothing differences cumsum prefixes of ~1e3 (ulp ~6e-5),
    # so slopes agree to 1e-4 and the intercept c = d - a x - b y to
    # 1e-4 * (h + w); the planes' disparities agree to 1e-4 everywhere
    for w_, g_, tol in zip(want, got, (1e-4, 1e-4, 1e-4 * (48 + 64))):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5, atol=tol)
    dj = np.asarray(jmst.labels_to_disparity(*want, fj, 16)) * 15.0
    dt = tmst.labels_to_disparity(*got, ft, 16).numpy() * 15.0
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("start", [None, 2.0, 5.0])
def test_refine_deltas(start):
    for wj, wt in zip(jmst.refine_deltas(128, start), tmst.refine_deltas(128, start, "cpu")):
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def test_candidates_same_key(rng):
    """Same key, same candidate planes (the RNG stream is bit-exact)."""
    fj, ft = _shared_forest(rng)
    n, d = 48 * 64, 16
    a, b, c = _labels(rng, n, d)
    key = jax.random.PRNGKey(11)
    dj = jmst.refine_deltas(d, 2.0)
    dt = tmst.refine_deltas(d, 2.0, "cpu")
    cj = jmst.make_candidate_fn(key, jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), fj, d, 2, *dj)
    ct = tmst.make_candidate_fn(key_from_jax(key, "cpu"), *(torch.from_numpy(x) for x in (a, b, c)),
                                ft, d, 2, *dt)
    for j in range(2 + dt[0].shape[0]):
        for w_, g_ in zip(cj(j), ct(j)):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-6, atol=1e-6)


def test_seeded_optimize_min_cost(rng):
    fj, ft = _shared_forest(rng)
    d = 16
    cfg = production_mst_config(d, on_tpu=False, min_cc_size=20, c=800.0)
    tcfg = port_cfg(cfg)
    vol = (rng.random((48, 64, d)) * 0.5).astype(np.float32)
    seed = np.clip(8 + 3 * np.sin(np.arange(64) / 9.0)[None, :] + np.zeros((48, 1)), 0, d - 1)
    seed = seed.astype(np.float32)
    key = jax.random.PRNGKey(4)
    jv = jnp.asarray(vol).astype(cfg.volume_dtype)
    tv = torch.from_numpy(vol).to(torch.bfloat16)
    lj = jmst.plane_labels_from_disparity(jnp.asarray(seed), fj)
    lt = tmst.plane_labels_from_disparity(torch.from_numpy(seed), ft)
    mj = j_seed_min_cost(jv, *lj, fj, cfg)
    mt = t_seed_min_cost(tv, *lt, ft, tcfg)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-4, atol=1e-4)
    kw = dict(max_neighbors=2, iterations=3, refine_start=2.0)
    *_, mc_j = jmst.mst_pms_optimize(key, jv, fj, cfg, init_state=(*lj, mj), **kw)
    a, b, c, mc_t = tmst.mst_pms_optimize(key_from_jax(key, "cpu"), tv, ft, tcfg, init_state=(*lt, mt), **kw)
    np.testing.assert_allclose(mc_t.numpy(), np.asarray(mc_j), rtol=1e-3, atol=1e-3)
    assert (mc_t <= mt + 1e-6).all()  # the seed is sticky: costs only drop
    # candidate_chunk evaluates the same candidates with a running min
    chunked = tmst.mst_pms_optimize(key_from_jax(key, "cpu"), tv, ft, tcfg, init_state=(*lt, mt),
                                    candidate_chunk=3, **kw)
    for x, y in zip(chunked, (a, b, c, mc_t)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_cpu_tensor_takes_the_twin(rng):
    before = segmented_cumsum.launches
    x, reset = torch.rand(3, 300), torch.ones(300, dtype=torch.bool)
    segmented_cumsum(x, reset)
    assert segmented_cumsum.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        segmented_cumsum(x.to("meta"), reset.to("meta"))
