"""The benchmark's frozen arithmetic: the kernels' byte counts reproduce
the bounds the port's records give (PERF.md, the kernel table: K1 in
bf16 at 960x1152x128 0.254 ms, K1c a band of the 2048x1536x256 frame
0.1455 ms, K2's Euler scan 0.0418 ms and K2a 0.0279 ms at 7 rows on a
960x1280 forest), the launches a frame match the program's (a keyframe
K2 20 / K2a 20, a temporal frame 12 / 12, a band-streamed call K1c 23),
and the interval union, the gaps, the percentile and the GT scoring on
hand-made inputs."""

import numpy as np
import pytest
import torch

from portbench import yardstick as ys

N = 960 * 1280


@pytest.mark.parametrize("nbytes,ms", [
    (ys.k1_bytes(960, 1152, 128, 2), 0.2535),
    (128 * 1776 * 256 * 8 + 2 * 6 * 1776 * 256 * 4, 0.1455),
    (ys.k2_scan_bytes(7, 2 * N), 0.0418),
    (ys.k2_scan_bytes(7, N), 0.0209),
    (ys.k2a_bytes(7, N), 0.0279),
])
def test_bounds_reproduce_the_records(nbytes, ms):
    assert ys.bound_s(nbytes) * 1e3 == pytest.approx(ms, abs=5e-5)


def test_k1_is_bound_by_bytes():
    assert ys.bound_s(ys.k1_bytes(960, 1152, 128, 2), ys.k1_ops(960, 1152, 128, 8)) == \
        ys.bound_s(ys.k1_bytes(960, 1152, 128, 2))


def test_k1c_call_launches_and_bytes():
    launches, nbytes = ys.k1c_call_bytes(1536, 1776, 256, 4)
    assert launches == 23
    band = 128 * 1776 * 256
    plane = 1776 * 256 * 4
    assert nbytes == 12 * (band * 8 + 12 * plane) + 11 * (band * 4 + 6 * plane)
    assert ys.bound_s(12 * (band * 8 + 12 * plane)) / 12 * 1e3 == pytest.approx(0.1455, abs=5e-5)


def test_tree_filter_rows_and_launches_of_a_frame():
    key = ys.tree_filter_rows(128, 4, 2.0, 2)
    temporal = ys.tree_filter_rows(128, 2, 4.0, 2)
    assert key == [1, 7, 7, 7, 7] and temporal == [1, 8, 8]
    k, t = ys.k2_frame(N, key, 1), ys.k2_frame(N, temporal, 1)
    assert (k["k2_launches"], k["k2a_launches"]) == (20, 20)
    assert (t["k2_launches"], t["k2a_launches"]) == (12, 12)
    assert k["k2_bytes"] == 2 * 2 * sum(ys.k2_scan_bytes(r, N) for r in key)
    from stereomatch_tpu_torch.ops.mst import refine_deltas

    for d, start in ((128, None), (128, 2.0), (128, 4.0), (64, 0.3), (16, 0.05)):
        assert ys.refine_ladder(d, start) == refine_deltas(d, start, "cpu")[0].numel()


def test_busy_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (10.0, 10.0)]
    assert ys.busy_s(iv) == 4.0
    assert ys.busy_s([]) == 0.0
    assert ys.idle_gaps(iv, -1.0, 12.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 10.0), (10.0, 12.0)]


def test_percentile_over_all_values():
    v = list(range(1, 101))
    assert ys.percentile(v, 90.0) == pytest.approx(np.percentile(v, 90.0))
    assert ys.percentile([5.0], 90.0) == 5.0
    assert ys.median([3.0, 1.0, 2.0]) == 2.0
    rng = np.random.default_rng(0)
    x = rng.exponential(size=137)
    assert ys.percentile(x, 90.0) == pytest.approx(np.percentile(x, 90.0), rel=1e-12)


def test_lr_valid_matches_the_programs_lr_check():
    from stereomatch_tpu_torch.ops.postprocess import lr_consistency

    rng = np.random.default_rng(1)
    left = rng.uniform(-2, 20, (30, 40)).astype(np.float32)
    right = (left + rng.normal(0, 1.0, left.shape)).astype(np.float32)
    _, want = lr_consistency(torch.from_numpy(left), torch.from_numpy(right), 16.0, fill=False)
    np.testing.assert_array_equal(ys.lr_valid(left, right, 16.0), want.numpy())


def test_bad_counts():
    gt = np.array([[1.0, 2.0, 3.0, 4.0]], np.float32)
    est = np.array([[1.0, 4.5, 3.0, 9.0]], np.float32)
    valid = np.array([[True, True, False, True]])
    scored = np.array([[True, True, True, False]])
    assert ys.bad_counts(est, valid, gt, scored) == (2, 3)  # off by 2.5; invalid
