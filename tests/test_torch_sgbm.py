"""The port's SGBM (ops/sgbm.py, K1 in ops/sgbm_cuda.py) and the fill / LR
check against the JAX package.

With integer-valued images (what a camera gives) every SGBM cost is an
integer and every partial sum stays below 2^24, so float32 sums are exact
in any order: the cost volume, the aggregated volume and the selected
disparities must be EXACTLY equal. The twin also equals the JAX Pallas
kernel bitwise on non-integer costs (same DP expression, same per-pixel
order of the sum over directions). bf16 costs are held at the disparity
level: the JAX package aggregates with a bf16 carry, the port in float32
(D1 < 0.5%, the gate of tests/test_sgbm.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.config import SGBMConfig
from stereomatch_tpu.models.sgbm_mst import _seed_pair as j_seed_pair
from stereomatch_tpu.ops import postprocess as jpost
from stereomatch_tpu.ops import sgbm as jsgbm
from stereomatch_tpu.ops.sgbm_pallas import aggregate_8path_pallas
from stereomatch_tpu_torch.models.sgbm_mst import _seed_pair as t_seed_pair
from stereomatch_tpu_torch.ops import postprocess as tpost
from stereomatch_tpu_torch.ops import sgbm as tsgbm
from stereomatch_tpu_torch.ops.sgbm_cuda import aggregate_8path_cuda
from test_torch_config import port_cfg

CFG = SGBMConfig(min_disp=0, num_disp=16, block_size=5)
TCFG = port_cfg(CFG)  # the same fields in the port's own config


def _int_pair(rng, h=48, w=64, shift=5):
    base = rng.random((h, w + shift))
    for _ in range(2):
        base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 0)) / 3
    base = np.round(base * 255).astype(np.float32)
    return base[:, :w], base[:, shift : shift + w]


def test_cost_volume_exact(rng):
    left, right = _int_pair(rng)
    np.testing.assert_array_equal(
        tsgbm.xsobel_clipped(torch.from_numpy(left)).numpy(),
        np.asarray(jsgbm.xsobel_clipped(jnp.asarray(left))),
    )
    want = np.asarray(jsgbm.sgbm_cost_volume(jnp.asarray(left), jnp.asarray(right), CFG))
    got = tsgbm.sgbm_cost_volume(torch.from_numpy(left), torch.from_numpy(right), TCFG).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got, np.round(got))  # integer-valued


@pytest.mark.parametrize("num_paths", [8, 5, 4])
def test_aggregate_twin_exact_vs_scan(rng, num_paths):
    cost = rng.integers(0, 3000, (16, 24, 16)).astype(np.float32)
    want = np.asarray(jsgbm.aggregate_8path(jnp.asarray(cost), 200.0, 800.0, num_paths))
    got = tsgbm.aggregate_8path(torch.from_numpy(cost), 200.0, 800.0, num_paths).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_paths", [8, 4])
@pytest.mark.parametrize("integer", [True, False])
def test_aggregate_twin_exact_vs_pallas(rng, num_paths, integer):
    cost = rng.random((16, 24, 16)) * 50
    cost = (np.round(cost) if integer else cost).astype(np.float32)
    want = np.asarray(aggregate_8path_pallas(jnp.asarray(cost), 7.0, 29.0, num_paths, interpret=True))
    got = aggregate_8path_cuda(torch.from_numpy(cost), 7.0, 29.0, num_paths).numpy()
    np.testing.assert_array_equal(got, want)


def test_aggregate_twin_bf16_costs_f32_state(rng):
    """bf16 costs are upcast exactly; the state and S stay float32."""
    cost = rng.integers(0, 3000, (12, 20, 16)).astype(np.float32)
    c16 = torch.from_numpy(cost).to(torch.bfloat16)
    got = tsgbm.aggregate_8path(c16, 200.0, 800.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), tsgbm.aggregate_8path(c16.float(), 200.0, 800.0).numpy())


def test_sgbm_disparity_exact(rng):
    left, right = _int_pair(rng)
    want = jsgbm.sgbm_disparity(jnp.asarray(left), jnp.asarray(right), CFG)
    got = tsgbm.sgbm_disparity(torch.from_numpy(left), torch.from_numpy(right), TCFG)
    np.testing.assert_array_equal(got.disparity.numpy(), np.asarray(want.disparity))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.right_disparity.numpy(), np.asarray(want.right_disparity))
    assert got.valid.float().mean() > 0.5


def test_sgbm_bf16_d1_gate(rng):
    left, right = _int_pair(rng, 96, 128, 9)
    cfg16 = SGBMConfig(min_disp=0, num_disp=32, block_size=5, cost_dtype="bfloat16")
    a = jsgbm.sgbm_disparity(jnp.asarray(left), jnp.asarray(right), cfg16)
    b = tsgbm.sgbm_disparity(torch.from_numpy(left), torch.from_numpy(right), port_cfg(cfg16))
    both = np.asarray(a.valid) & b.valid.numpy()
    assert both.mean() > 0.5
    da, db = np.asarray(a.disparity), b.disparity.numpy()
    err = np.abs(da - db)[both]
    d1 = ((err > 3.0) & (err > 0.05 * np.abs(da[both]))).mean()
    assert d1 < 0.005, d1


@pytest.mark.parametrize("right_seed", ["disp2", "mirror"])
def test_seed_pair_exact(rng, right_seed):
    left, right = _int_pair(rng)
    wl, wr = j_seed_pair(jnp.asarray(left), jnp.asarray(right), CFG, right_seed)
    tl, tr = t_seed_pair(torch.from_numpy(left), torch.from_numpy(right), TCFG, right_seed)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(wr))


@pytest.mark.parametrize("gray", ["integer", "luma"])
@pytest.mark.parametrize("cost_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_paths", [8, 5, 4])
def test_production_cost_sums_in_any_order(gray, cost_dtype, num_paths):
    """The premise of K1's reductions, which land in any order, on the
    production SGBM cost. From integer-valued gray images (an 8-bit gray
    frame, what OpenCV's SGBM takes) the cost is integer-valued in float32
    and in bfloat16, every partial sum of S is exact, and summing the
    directions in another order gives the twin's S bit for bit. From the
    float BT.601 luma of a BGR frame (`_gray_from_bgr`, the server's path)
    the cost is not integer-valued, and another order agrees with the twin
    to float32 reassociation: two orders of a sum of n <= 8 non-negative
    terms differ by at most 2 (n - 1) 2^-24 of the sum, below 1e-6."""
    import dataclasses

    from stereomatch_tpu_torch.config import production_mst_config
    from stereomatch_tpu_torch.models.sgbm_mst import _default_sgbm_cfg, _gray_from_bgr
    from stereomatch_tpu_torch.synthetic import render_scene

    sc = render_scene(4, 40, 96, 32)
    gl, gr = (_gray_from_bgr(torch.from_numpy(x)) for x in (sc.left, sc.right))
    if gray == "integer":
        gl, gr = gl.round(), gr.round()
    cfg = dataclasses.replace(
        _default_sgbm_cfg(production_mst_config(32, forest_backend="device")),
        cost_dtype=cost_dtype)
    p1, p2 = (float(p) for p in cfg.resolved_p1p2())
    c = tsgbm.sgbm_cost_volume(gl, gr, cfg)
    c = c[:, cfg.min_disp + cfg.num_disp:].contiguous()  # the columns K1 aggregates
    assert c.dtype == getattr(torch, cost_dtype) and c.shape == (40, 64, 32)
    cf = c.float()
    assert torch.equal(cf, cf.round()) == (gray == "integer")
    assert p1 == round(p1) and p2 == round(p2)
    want = tsgbm.aggregate_8path(c, p1, p2, num_paths)
    assert want.max() <= num_paths * (cf.max() + p2) < 2**24
    dirs = list(tsgbm.SGBM_DIRECTIONS[num_paths])
    for order in (dirs[::-1], dirs[1::2] + dirs[::2]):
        s = torch.zeros_like(cf)
        for dy, dx in order:
            tsgbm._direction_pass(cf, s, dy, dx, p1, p2)
        if gray == "integer":
            assert torch.equal(s, want)
        else:
            torch.testing.assert_close(s, want, rtol=1e-6, atol=0.0)


def test_fill_and_lr_check_exact(rng):
    disp = (rng.random((20, 30)) * 12).astype(np.float32)
    disp[:, :3] = 2.5  # exact .5 values: half-to-even rounding
    valid = rng.random((20, 30)) > 0.4
    valid[3] = False  # a row with nothing to fill from
    right = (rng.random((20, 30)) * 12).astype(np.float32)
    np.testing.assert_array_equal(
        tpost.nearest_valid_fill(torch.from_numpy(disp), torch.from_numpy(valid)).numpy(),
        np.asarray(jpost.nearest_valid_fill(jnp.asarray(disp), jnp.asarray(valid))),
    )
    for fill in (False, True):
        wd, wv = jpost.lr_consistency(jnp.asarray(disp), jnp.asarray(right), 12.0, fill=fill)
        td, tv = tpost.lr_consistency(torch.from_numpy(disp), torch.from_numpy(right), 12.0, fill=fill)
        np.testing.assert_array_equal(td.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


def test_cpu_tensor_takes_the_twin(rng):
    """A CPU tensor never launches K1; the count stays put."""
    before = aggregate_8path_cuda.launches
    cost = torch.from_numpy(rng.integers(0, 99, (6, 9, 16)).astype(np.float32))
    aggregate_8path_cuda(cost, 7.0, 29.0)
    assert aggregate_8path_cuda.launches == before
    # only a CPU tensor takes the twin; no other device falls back to it
    with pytest.raises(ValueError, match="CUDA"):
        aggregate_8path_cuda(cost.to("meta"), 7.0, 29.0)

