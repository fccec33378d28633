"""The port's band-streamed SGBM (ops/sgbm.py::sgbm_disparity_banded, the
carried DP of ops/sgbm.py::aggregate_paths, the twin of kernel K1c) and
sgbm_pipeline's band branch, against the JAX package on the CPU.

On integer-valued images every SGBM cost, Lr and partial sum is an integer
below 2^24, so float32 sums are exact in any order: the banded SGBM's
disparity, validity and right-view maps equal JAX's bit for bit, for 8, 5
and 4 paths, with a height that is not a multiple of the band, and the
carried band DP's state equals JAX's `_row_scan_dirs` carry bit for bit.
On non-integer gray the band costs' block sums can differ from the whole
frame's by an ulp, so banded against monolithic is held to under 0.2% of
pixels flipped (tests/test_sgbm_banded.py's bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.config import SGBMConfig
from stereomatch_tpu.ops import sgbm as jsgbm
from stereomatch_tpu_torch import pipelines as tpipelines
from stereomatch_tpu_torch.ops import sgbm as tsgbm
from stereomatch_tpu_torch.ops.sgbm_cuda import aggregate_paths_cuda
from test_torch_config import port_cfg

H, W = 70, 96  # 70 rows: bands of 16 leave a remainder of 6


def _int_pair(rng, h=H, w=W, shift=5):
    base = rng.random((h, w + 8))
    for _ in range(2):
        base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 0)) / 3
    base = np.round(base * 255).astype(np.float32)
    return base[:, :w], base[:, shift:shift + w]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("num_paths", [8, 5, 4])
def test_banded_bitwise_vs_jax(rng, num_paths):
    left, right = _int_pair(rng)
    cfg = SGBMConfig(min_disp=0, num_disp=16, block_size=5, num_paths=num_paths)
    want = jsgbm.sgbm_disparity_banded(jnp.asarray(left), jnp.asarray(right), cfg, band_rows=16)
    got = tsgbm.sgbm_disparity_banded(torch.from_numpy(left), torch.from_numpy(right),
                                      port_cfg(cfg), band_rows=16, device="cpu")
    np.testing.assert_array_equal(got.disparity.numpy(), np.asarray(want.disparity))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.right_disparity.numpy(), np.asarray(want.right_disparity))
    assert got.disparity.shape == (H, W) and got.valid.float().mean() > 0.5
    assert got.aggregated.numel() == 0


@pytest.mark.parametrize("reverse", [False, True])
def test_carried_band_dp_bitwise_vs_row_scan_dirs(rng, reverse):
    """One band's three carried directions of one sweep from a non-zero
    (3, W, D) carry: the per-row direction sums and the final carry equal
    JAX's _row_scan_dirs bit for bit on integer costs (the twin sums S
    direction by direction, JAX within the row: exact on integers)."""
    cost = rng.integers(0, 300, (12, 24, 16)).astype(np.float32)
    carry = rng.integers(1, 2000, (3, 24, 16)).astype(np.float32)
    ys, final = jsgbm._row_scan_dirs(jnp.asarray(cost), jnp.asarray(carry), 30.0, 120.0, 3,
                                     reverse=reverse)
    dirs = tsgbm.SGBM_DIRECTIONS[8][3:6] if reverse else tsgbm.SGBM_DIRECTIONS[8][:3]
    out = torch.empty(3, 24, 16)
    s = aggregate_paths_cuda(torch.from_numpy(cost), 30.0, 120.0, dirs, torch.from_numpy(carry),
                             out)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ys))
    np.testing.assert_array_equal(out.numpy(), np.asarray(final))
    # without S: the same carry, and no volume
    out2 = torch.empty(3, 24, 16)
    assert aggregate_paths_cuda(torch.from_numpy(cost), 30.0, 120.0, dirs,
                                torch.from_numpy(carry), out2, with_s=False) is None
    assert torch.equal(out2, out)


def test_carried_dp_without_carry_is_k1_twin(rng):
    """No carry in: the carried twin over K1's directions is K1's twin."""
    cost = torch.from_numpy(rng.integers(0, 300, (10, 20, 16)).astype(np.float32))
    got = aggregate_paths_cuda(cost, 30.0, 120.0, tsgbm.SGBM_DIRECTIONS[8])
    assert torch.equal(got, tsgbm.aggregate_8path(cost, 30.0, 120.0, 8))


@pytest.mark.parametrize("num_paths", [8, 4])
def test_banded_vs_monolithic_float_gray(rng, num_paths):
    """Non-integer gray (BT.601 luma of a colour pair): under 0.2% of pixels
    flip between the banded SGBM and the whole frame."""
    h, w = 61, 88
    base = (rng.random((h, w + 8, 3)) * 255).astype(np.float32)
    gray = base @ np.array([0.299, 0.587, 0.114], np.float32)
    left, right = torch.from_numpy(gray[:, :w]), torch.from_numpy(gray[:, 5:5 + w].copy())
    cfg = port_cfg(SGBMConfig(min_disp=0, num_disp=16, block_size=5, num_paths=num_paths))
    mono = tsgbm.sgbm_disparity(left, right, cfg)
    band = tsgbm.sgbm_disparity_banded(left, right, cfg, band_rows=16, device="cpu")
    flipped = (mono.valid != band.valid) | ((mono.disparity - band.disparity).abs() > 1e-5)
    assert flipped.float().mean().item() < 0.002


def test_sgbm_pipeline_takes_band_branch(rng, monkeypatch):
    """Above SGBM_BAND_THRESHOLD_BYTES (2 GiB, as the JAX package) the
    pipeline streams bands: lowered to 0 here, the banded SGBM runs, and on
    an integer pair its map with speckle equals the whole-frame pipeline's."""
    assert tpipelines.SGBM_BAND_THRESHOLD_BYTES == 2 << 30
    left, right = _int_pair(rng, 48, 80)
    cfg = port_cfg(SGBMConfig(min_disp=0, num_disp=16, block_size=5))
    mono = tpipelines.sgbm_pipeline(left, right, cfg, device="cpu")
    calls = []
    banded = tsgbm.sgbm_disparity_banded

    def spy(*a, **k):
        calls.append(k)
        return banded(*a, **k)

    monkeypatch.setattr(tsgbm, "sgbm_disparity_banded", spy)
    monkeypatch.setattr(tpipelines, "SGBM_BAND_THRESHOLD_BYTES", 0)
    band = tpipelines.sgbm_pipeline(left, right, cfg, device="cpu")
    assert len(calls) == 1
    np.testing.assert_array_equal(band, mono)
    # and the JAX pipeline's map at the same size (monolithic there: exact)
    from stereomatch_tpu import pipelines as jpipelines

    np.testing.assert_array_equal(band, jpipelines.sgbm_pipeline(left, right, SGBMConfig(
        min_disp=0, num_disp=16, block_size=5)))
