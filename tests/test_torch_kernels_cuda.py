"""The port's hand-written kernels against their plain PyTorch twins on a
CUDA device. These tests skip without one (a CUDA kernel has no CPU mode).
The file imports neither jax nor anything from conftest, so it also runs on
a GPU machine without jax:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

K1 computes each direction's Lr as its twin does and adds it into S with
atomic reductions, in any order. On integer-valued costs every partial sum
is exact, so K1 equals its twin bit for bit; on other costs the two agree
to float32 reassociation of the sum over directions (rtol 1e-6: two orders
of a sum of n <= 8 non-negative terms differ by at most 2 (n - 1) 2^-24 of
the sum). K1c, K1's carry entry, is held the same way, and its carries
(each one direction's Lr, no sum) bit for bit on any cost. K2 agrees with
its twin to rtol 1e-5 / atol 1e-4: both use the same 256-element blocks
but sum in different orders; on integer-valued inputs every partial sum is
exact and they agree bit for bit. K2 is one launch a call, whose tiles
pass the open segment on by a look-back through a per-stream workspace
that is never cleared; the tests below run it where the look-back goes
deep (long segments), across calls and sizes that reuse the workspace,
and with the ancestor sum's gathers fused. K3, the threefry draws of
random.py, equals its int64 twin bit for bit (integer rounds, one explicit
FMA), one launch a draw and no sync.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereomatch_tpu_torch import random as trandom
from stereomatch_tpu_torch.ops.mst_scan_cuda import (
    ancestor_sums, ancestor_sums_twin, lookback_counts, segmented_cumsum, segmented_cumsum_twin,
)
from stereomatch_tpu_torch.ops.sgbm import SGBM_DIRECTIONS, aggregate_8path, aggregate_paths
from stereomatch_tpu_torch.ops.sgbm_cuda import aggregate_8path_cuda, aggregate_paths_cuda

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    # no TF32 anywhere a reference is computed on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# D = 16 and 256 (the kernel's smallest and largest), a single row, a single
# column, one pixel, and D = 80 and 144, whose last lane holds a part of its
# disparities (the scalar reduction path)
K1_SHAPES = [(37, 53, 48), (9, 300, 256), (64, 40, 16), (1, 70, 32), (50, 1, 32), (1, 1, 16),
             (23, 31, 80), (11, 19, 144), (40, 29, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_paths", [8, 5, 4])
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_bitwise_vs_twin(cuda, dtype, num_paths, shape):
    """Integer-valued costs: every partial sum of S is exact, so the order
    the reductions land in cannot show, and K1 equals its twin bit for bit.
    One launch per call, whatever the number of directions."""
    rng = np.random.default_rng(0)
    cost = torch.from_numpy(rng.integers(0, 3000, shape).astype(np.float32)).to(dtype)
    before = aggregate_8path_cuda.launches
    got = aggregate_8path_cuda(cost.to(cuda), 200.0, 800.0, num_paths)
    assert aggregate_8path_cuda.launches == before + 1
    assert torch.equal(got.cpu(), aggregate_8path(cost, 200.0, 800.0, num_paths))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(37, 53, 48), (9, 300, 256), (40, 29, 128)])
def test_k1_float_costs_vs_twin(cuda, dtype, shape):
    """Non-integer costs (and P1, P2): within float32 reassociation of the
    sum over 8 directions, rtol 1e-6."""
    rng = np.random.default_rng(3)
    cost = torch.from_numpy((rng.random(shape) * 3000).astype(np.float32)).to(dtype)
    before = aggregate_8path_cuda.launches
    got = aggregate_8path_cuda(cost.to(cuda), 200.5, 800.25, 8)
    assert aggregate_8path_cuda.launches == before + 1
    want = aggregate_8path(cost, 200.5, 800.25, 8)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
def test_k1_wrapper_rejects(cuda):
    c = torch.zeros((8, 20, 16), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        aggregate_8path_cuda(c[:, 4:], 1.0, 2.0)
    with pytest.raises(ValueError, match="D <= 256"):
        aggregate_8path_cuda(torch.zeros((4, 4, 24), device=cuda), 1.0, 2.0)
    with pytest.raises(TypeError):
        aggregate_8path_cuda(c.double(), 1.0, 2.0)
    with pytest.raises(ValueError, match="num_paths"):
        aggregate_8path_cuda(c, 1.0, 2.0, num_paths=3)
    flat = torch.zeros(8 * 20 * 16 + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        aggregate_8path_cuda(flat[1:].view(8, 20, 16), 1.0, 2.0)
    before = aggregate_8path_cuda.launches
    assert aggregate_8path_cuda(torch.zeros((0, 5, 16), device=cuda), 1.0, 2.0).shape == (0, 5, 16)
    assert aggregate_8path_cuda.launches == before  # nothing to launch


# K1c's direction sets: a banded down-sweep of 8 paths (6 carried, E and W
# in the same launch), of 5 paths (3 carried) and of 4 paths (2 carried),
# and an up-sweep that only records its carry (3 carried, no S)
K1C_SETS = {"down8": (SGBM_DIRECTIONS[8], True), "down5": (SGBM_DIRECTIONS[5], True),
            "down4": (SGBM_DIRECTIONS[4], True), "up": (SGBM_DIRECTIONS[8][3:6], False)}


def _k1c_case(rng, shape, dirs, integer=True):
    """(cost, carry_in): a cost and a carry that is non-zero everywhere."""
    carried = sum(dy != 0 for dy, _ in dirs)
    if integer:
        cost = rng.integers(0, 3000, shape).astype(np.float32)
        carry = rng.integers(1, 5000, (carried,) + shape[1:]).astype(np.float32)
    else:
        cost = (rng.random(shape) * 3000).astype(np.float32)
        carry = (rng.random((carried,) + shape[1:]) * 5000 + 1).astype(np.float32)
    return torch.from_numpy(cost), torch.from_numpy(carry)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dir_set", list(K1C_SETS))
@pytest.mark.parametrize("shape", [(37, 53, 48), (16, 300, 256), (1, 70, 32), (9, 1, 16),
                                   (23, 31, 80), (128, 96, 256)])
def test_k1c_bitwise_vs_twin(cuda, dtype, dir_set, shape):
    """Integer costs and a random non-zero carry: S and the carry out equal
    the twin's bit for bit for every carried direction of both sweeps,
    diagonal walks that wrap included; one launch a call."""
    dirs, with_s = K1C_SETS[dir_set]
    rng = np.random.default_rng(5)
    cost, carry = _k1c_case(rng, shape, dirs)
    cost = cost.to(dtype)
    out = torch.full_like(carry, -1.0, device=cuda)
    before = aggregate_paths_cuda.launches
    got = aggregate_paths_cuda(cost.to(cuda), 200.0, 800.0, dirs, carry.to(cuda), out,
                               with_s=with_s)
    assert aggregate_paths_cuda.launches == before + 1
    want_out = torch.empty_like(carry)
    want = aggregate_paths(cost, 200.0, 800.0, dirs, carry, want_out, with_s=with_s)
    assert torch.equal(out.cpu(), want_out)
    if with_s:
        assert torch.equal(got.cpu(), want)
    else:
        assert got is None and want is None


@pytest.mark.cuda
@pytest.mark.parametrize("dir_set", ["down8", "up"])
def test_k1c_float_costs_vs_twin(cuda, dir_set):
    """Non-integer costs and carries: the carries bit for bit (each is one
    direction's Lr, computed as the twin does), S within rtol 1e-6."""
    dirs, with_s = K1C_SETS[dir_set]
    cost, carry = _k1c_case(np.random.default_rng(6), (40, 77, 128), dirs, integer=False)
    out = torch.empty_like(carry, device=cuda)
    got = aggregate_paths_cuda(cost.to(cuda), 200.5, 800.25, dirs, carry.to(cuda), out,
                               with_s=with_s)
    want_out = torch.empty_like(carry)
    want = aggregate_paths(cost, 200.5, 800.25, dirs, carry, want_out, with_s=with_s)
    assert torch.equal(out.cpu(), want_out)
    if with_s:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("num_paths", [8, 5, 4])
def test_k1c_without_carry_is_k1(cuda, num_paths):
    """No carry and an S: the carry entry computes K1's S, and K1 itself is
    unchanged against its twin."""
    rng = np.random.default_rng(7)
    cost = torch.from_numpy(rng.integers(0, 3000, (33, 61, 64)).astype(np.float32)).to(cuda)
    k1 = aggregate_8path_cuda(cost, 200.0, 800.0, num_paths)
    assert torch.equal(aggregate_paths_cuda(cost, 200.0, 800.0, SGBM_DIRECTIONS[num_paths]), k1)
    assert torch.equal(k1.cpu(), aggregate_8path(cost.cpu(), 200.0, 800.0, num_paths))


@pytest.mark.cuda
def test_k1c_wrapper_rejects(cuda):
    dirs = SGBM_DIRECTIONS[8][:3]
    c = torch.zeros((8, 20, 16), device=cuda)
    carry = torch.zeros((3, 20, 16), device=cuda)
    with pytest.raises(ValueError, match=r"\(3, 20, 16\)"):
        aggregate_paths_cuda(c, 1.0, 2.0, dirs, torch.zeros((2, 20, 16), device=cuda))
    with pytest.raises(ValueError, match="float32"):
        aggregate_paths_cuda(c, 1.0, 2.0, dirs, carry.double())
    with pytest.raises(ValueError, match="float32"):
        aggregate_paths_cuda(c, 1.0, 2.0, dirs, None, carry.cpu())
    with pytest.raises(ValueError, match="overlap"):
        aggregate_paths_cuda(c, 1.0, 2.0, dirs, carry, carry)
    with pytest.raises(ValueError, match="directions"):
        aggregate_paths_cuda(c, 1.0, 2.0, [(0, 0)])
    with pytest.raises(ValueError, match="contiguous"):
        aggregate_paths_cuda(c[:, 4:], 1.0, 2.0, dirs)


@pytest.mark.cuda
@pytest.mark.parametrize("num_paths", [8, 5, 4])
def test_banded_sgbm_on_card_equals_cpu(cuda, num_paths):
    """sgbm_disparity_banded on the card (K1c for every band) equals its
    CPU twin bit for bit on an integer pair, with 2 nbands - 1 launches
    (nbands without upward paths) and no K1."""
    from stereomatch_tpu_torch.config import SGBMConfig
    from stereomatch_tpu_torch.ops.sgbm import sgbm_disparity_banded

    rng = np.random.default_rng(8)
    base = rng.random((150, 200))
    for _ in range(2):
        base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 0)) / 3
    base = torch.from_numpy(np.round(base * 255).astype(np.float32))
    left, right = base[:, :192].contiguous(), base[:, 5:197].contiguous()
    cfg = SGBMConfig(min_disp=0, num_disp=32, block_size=5, num_paths=num_paths)
    k1, k1c = aggregate_8path_cuda.launches, aggregate_paths_cuda.launches
    got = sgbm_disparity_banded(left, right, cfg, band_rows=32, device=cuda)
    nb = 5  # 150 rows in bands of 32
    assert aggregate_paths_cuda.launches - k1c == (nb if num_paths == 5 else 2 * nb - 1)
    assert aggregate_8path_cuda.launches == k1
    want = sgbm_disparity_banded(left, right, cfg, band_rows=32, device="cpu")
    assert torch.equal(got.disparity.cpu(), want.disparity)
    assert torch.equal(got.valid.cpu(), want.valid)
    assert torch.equal(got.right_disparity.cpu(), want.right_disparity)


def _resets(rng, m, mean_seg):
    """reset[0] and, if mean_seg, about one reset per mean_seg elements."""
    reset = rng.random(m) < 1.0 / mean_seg if mean_seg else np.zeros(m, bool)
    reset[0] = True
    return torch.from_numpy(reset)


# m < one 1024-element tile, ragged tails (m not a multiple of 4, 8, 256
# or 1024), k = 1 (its own one-row tiles), 7 (row groups of 4 and 3) and
# 13 (four row groups), and
# look-back that runs deep: one segment over the whole row (None), and
# m = 3,000,000 with mean segment 100,000
K2_CASES = [(1000, 7, 1), (100000, 40, 7), (300000, 5000, 7), (257, 3, 2), (256, 256, 3),
            (1, None, 1), (5, 2, 7), (2049, None, 7), (100003, 50, 13), (1000001, None, 7),
            (2000002, None, 1), (3000000, 100000, 7), (3000000, 100000, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,mean_seg,k", K2_CASES)
def test_k2_vs_twin(cuda, m, mean_seg, k):
    rng = np.random.default_rng(1)
    reset = _resets(rng, m, mean_seg)
    x = torch.from_numpy((rng.random((k, m)) - 0.3).astype(np.float32))
    before = segmented_cumsum.launches
    got = segmented_cumsum(x.to(cuda), reset.to(cuda))
    assert segmented_cumsum.launches == before + 1
    torch.testing.assert_close(got.cpu(), segmented_cumsum_twin(x, reset), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m,mean_seg,k", K2_CASES)
def test_k2_integer_values_bitwise(cuda, m, mean_seg, k):
    """Integer values in [-8, 8]: every partial sum is exact in float32, so
    the order the look-back adds tiles in cannot show."""
    rng = np.random.default_rng(4)
    reset = _resets(rng, m, mean_seg)
    x = torch.from_numpy(rng.integers(-8, 9, (k, m)).astype(np.float32))
    got = segmented_cumsum(x.to(cuda), reset.to(cuda))
    assert torch.equal(got.cpu(), segmented_cumsum_twin(x, reset))


@pytest.mark.cuda
def test_k2_back_to_back_reuses_workspace(cuda):
    """50 calls in a row on one stream, with no reinitialisation between
    them: each call's epoch hides the words earlier calls left."""
    rng = np.random.default_rng(5)
    m = 300001
    reset = _resets(rng, m, 20000).to(cuda)
    xs = torch.from_numpy(rng.integers(-8, 9, (50, 7, m)).astype(np.float32)).to(cuda)
    before = segmented_cumsum.launches
    got = [segmented_cumsum(xs[i], reset) for i in range(50)]
    assert segmented_cumsum.launches == before + 50
    for i in (0, 1, 17, 48, 49):
        assert torch.equal(got[i], segmented_cumsum_twin(xs[i], reset))
    assert torch.equal(torch.stack(got), segmented_cumsum_twin(xs, reset))


@pytest.mark.cuda
def test_k2_interleaved_sizes(cuda):
    """Two sizes and row counts in turns on one workspace (the larger one
    first grows it mid-sequence), the plain scan and the ancestor sum
    alternating."""
    rng = np.random.default_rng(6)
    shapes = [(7, 70001, 300), (1, 500000, 30000)]
    inputs = []
    for k, m, mean_seg in shapes:
        reset = _resets(rng, m, mean_seg).to(cuda)
        x = torch.from_numpy(rng.integers(-8, 9, (k, m)).astype(np.float32)).to(cuda)
        inputs.append((x, reset, segmented_cumsum_twin(x, reset)))
    for turn in range(10):
        x, reset, want = inputs[turn % 2]
        assert torch.equal(segmented_cumsum(x, reset), want), turn
    f = _real_forest(cuda, 60, 90)
    v = torch.from_numpy(rng.integers(-8, 9, (7, f["in_pos"].shape[0])).astype(np.float32)).to(cuda)
    want_a = ancestor_sums_twin(v, *(f[k] for k in _EULER))
    for turn in range(6):
        x, reset, want = inputs[turn % 2]
        assert torch.equal(segmented_cumsum(x, reset), want), turn
        assert torch.equal(ancestor_sums(v, *(f[k] for k in _EULER)), want_a), turn


@pytest.mark.cuda
def test_k2_lookback_counts(cuda):
    """One segment in one row: every tile after the first looks back; the
    first call on a fresh stream counts its tiles."""
    from stereomatch_tpu_torch._build import load_kernels

    m = 81920
    tiles, _ = load_kernels().seg_scan_plan(1, m)
    reset = _resets(np.random.default_rng(0), m, None).to(cuda)
    x = torch.ones((1, m), device=cuda)
    torch.cuda.synchronize()
    with torch.cuda.stream(torch.cuda.Stream()):
        got = segmented_cumsum(x, reset)
        ids, looks, deep = lookback_counts(cuda)
    assert tiles > 1 and (ids, looks) == (tiles, tiles - 1) and 0 <= deep < tiles
    assert torch.equal(got.cpu(), torch.arange(1, m + 1, dtype=torch.float32)[None])


_EULER = ("euler_src", "euler_is_in", "euler_reset", "in_pos")


def _real_forest(cuda, h, w, seed=3):
    """The production forest of a rendered frame, built on the card."""
    from stereomatch_tpu_torch.config import production_mst_config
    from stereomatch_tpu_torch.models.mst import _fused_capacities
    from stereomatch_tpu_torch.models.sgbm_mst import _view_forest
    from stereomatch_tpu_torch.synthetic import render_scene

    d = 24
    cfg = production_mst_config(d, on_tpu=False, min_cc_size=100, c=2000.0,
                                forest_backend="device")
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    scene = render_scene(seed, h, w, d)
    return _view_forest(torch.from_numpy(scene.left).to(cuda), cfg, tmax, adj_cap)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 1])
def test_ancestor_sums_vs_twin_real_forest(cuda, k):
    """The fused ancestor sum on a real 120x160 forest: within the scans'
    tolerance on float values, bit for bit on integer values; the
    segmented scan of the node order too."""
    f = _real_forest(cuda, 120, 160)
    n = f["in_pos"].shape[0]
    rng = np.random.default_rng(7)
    euler = [f[key] for key in _EULER]
    v = torch.from_numpy((rng.random((k, n)) - 0.3).astype(np.float32)).to(cuda)
    before = ancestor_sums.launches
    got = ancestor_sums(v, *euler)
    assert ancestor_sums.launches == before + 1
    torch.testing.assert_close(got, ancestor_sums_twin(v, *euler), rtol=1e-5, atol=1e-4)
    vi = torch.from_numpy(rng.integers(-8, 9, (k, n)).astype(np.float32)).to(cuda)
    assert torch.equal(ancestor_sums(vi, *euler), ancestor_sums_twin(vi, *euler))
    assert torch.equal(ancestor_sums(vi[0], *euler), ancestor_sums_twin(vi[0], *euler))
    assert torch.equal(segmented_cumsum(vi, f["seg_root"]), segmented_cumsum_twin(vi, f["seg_root"]))


_COUNT_KERNELS = """
import json
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
names = []
for fn in calls:
    fn()  # warm: K2's workspace is allocated on the first call
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names.append([e.name for e in prof.events() if e.device_type == DeviceType.CUDA])
print(json.dumps(names))
"""


def _kernels_a_call(script):
    """For each of the `calls` that `script` builds, the names of the device
    kernels one call launches, from torch.profiler's CUDA events in a fresh
    process: on the H100 the profiler's device times drift from the host's
    by milliseconds as a process ages (0.09 ms to 2.1 ms within 47 s), and a
    session of a few microseconds late in a long process has then held no
    device event."""
    out = subprocess.run([sys.executable, "-c", script + _COUNT_KERNELS], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_K2_CALLS = """
import sys
import torch
sys.path.insert(0, "tests")
from test_torch_kernels_cuda import _EULER, _real_forest
from stereomatch_tpu_torch.ops.mst_scan_cuda import ancestor_sums, segmented_cumsum
cuda = torch.device("cuda")
f = _real_forest(cuda, 120, 160)
n = f["in_pos"].shape[0]
x = torch.rand((7, 2 * n), device=cuda)
v = torch.rand((7, n), device=cuda)
euler = [f[key] for key in _EULER]
calls = [lambda: segmented_cumsum(x, f["euler_reset"]), lambda: ancestor_sums(v, *euler),
         lambda: segmented_cumsum(v[0], f["seg_root"])]
"""


@pytest.mark.cuda
def test_k2_one_kernel_per_call(cuda):
    """Each wrapper call is one device kernel: no memset, no copy, no
    second phase, for the plain scan and the fused ancestor sum."""
    for names in _kernels_a_call(_K2_CALLS):
        assert len(names) == 1 and "seg_scan_kernel" in names[0], names


@pytest.mark.cuda
def test_k2_wrapper_rejects(cuda):
    x = torch.zeros((2, 300), device=cuda)
    r = torch.ones(300, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        segmented_cumsum(x.double(), r)
    with pytest.raises(ValueError, match="shape"):
        segmented_cumsum(x, r[:10])
    with pytest.raises(ValueError):
        segmented_cumsum(x, r.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        segmented_cumsum(torch.zeros((300, 2), device=cuda).t(), r)


@pytest.mark.cuda
def test_ancestor_sums_wrapper_rejects(cuda):
    v = torch.zeros((2, 150), device=cuda)
    src = torch.zeros(300, dtype=torch.int64, device=cuda)
    m = torch.ones(300, dtype=torch.bool, device=cuda)
    in_pos = torch.zeros(150, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        ancestor_sums(v.double(), src, m, m, in_pos)
    with pytest.raises(TypeError):
        ancestor_sums(v, src.int(), m, m, in_pos)
    with pytest.raises(ValueError, match="shape"):
        ancestor_sums(v, src, m[:10], m, in_pos)
    with pytest.raises(ValueError):
        ancestor_sums(v, src, m, m.cpu(), in_pos)
    with pytest.raises(ValueError, match="contiguous"):
        ancestor_sums(torch.zeros((150, 2), device=cuda).t(), src, m, m, in_pos)


_NVCC_ROUTE = """
import sys
import numpy as np, torch
from pathlib import Path
from stereomatch_tpu_torch import _build
from stereomatch_tpu_torch.ops.device_forest import build_forest_device
from stereomatch_tpu_torch.ops.mst_scan_cuda import (
    ancestor_sums, ancestor_sums_twin, segmented_cumsum, segmented_cumsum_twin)
from stereomatch_tpu_torch.ops.sgbm import SGBM_DIRECTIONS, aggregate_8path, aggregate_paths
from stereomatch_tpu_torch.ops.sgbm_cuda import aggregate_8path_cuda, aggregate_paths_cuda
ext = _build._load_with_nvcc(False, Path(sys.argv[1]))
assert Path(ext.__file__).parent == Path(sys.argv[1]), ext.__file__
_build.load_kernels = lambda verbose=False: ext
rng = np.random.default_rng(2)
cost = torch.from_numpy(rng.integers(0, 3000, (21, 70, 32)).astype(np.float32))
got = aggregate_8path_cuda(cost.cuda(), 200.0, 800.0, 8)
assert torch.equal(got.cpu(), aggregate_8path(cost, 200.0, 800.0, 8))
reset = torch.from_numpy(rng.random(5000) < 0.05)
reset[0] = True
x = torch.from_numpy((rng.random((7, 5000)) - 0.3).astype(np.float32))
got = segmented_cumsum(x.cuda(), reset.cuda())
torch.testing.assert_close(got.cpu(), segmented_cumsum_twin(x, reset), rtol=1e-5, atol=1e-4)
wr, wd = (torch.from_numpy(rng.random(s).astype(np.float32) * 90) for s in ((31, 44), (30, 45)))
raw = build_forest_device(wr.cuda(), wd.cuda(), c=300.0, min_size=4, tmax=2048,
                          adj_cap=16384)
euler = [raw[k] for k in ("euler_src", "euler_is_in", "euler_reset", "in_pos")]
v = torch.from_numpy(rng.integers(-8, 9, (7, 31 * 45)).astype(np.float32)).cuda()
assert torch.equal(ancestor_sums(v, *euler), ancestor_sums_twin(v, *euler))
assert (aggregate_8path_cuda.launches, segmented_cumsum.launches, ancestor_sums.launches) == (1, 1, 1)
from stereomatch_tpu_torch import random as trandom
key = trandom.PRNGKey(3, "cuda")
assert torch.equal(trandom.split(key, 7).cpu(), trandom.split_twin(key.cpu(), 7))
assert torch.equal(trandom.fold_in(key, 2**32 - 1).cpu(), trandom.fold_in_twin(key.cpu(), 2**32 - 1))
u = trandom.uniform(key, (4, 1001), -1.0, 1.0).cpu()
assert torch.equal(u.view(torch.int32),
                   trandom.uniform_twin(key.cpu(), (4, 1001), -1.0, 1.0).view(torch.int32))
assert (trandom.split.launches, trandom.fold_in.launches, trandom.uniform.launches) == (1, 1, 1)
"""


@pytest.mark.cuda
def test_nvcc_route_builds_both_kernels(cuda, tmp_path):
    """The build route taken where ninja is missing: one nvcc command. In a
    fresh process (one extension module of a name per process), every
    wrapper (K1, K2 and K2's ancestor sum, K3's split, fold_in and uniform)
    runs on the module it builds and agrees with its twin."""
    out = subprocess.run([sys.executable, "-c", _NVCC_ROUTE, str(tmp_path)],
                         capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]


# K3: keys with both words set, the high bit set, and a split child
K3_SEEDS = [0, 123456, -1, 2**31 - 1]
K3_SHAPES = [(0,), (1,), (15731,), (4, 15731), (3145728,), (4, 96, 128)]
K3_RANGES = [(0.0, 1.0), (-1.0, 1.0), (0.0, 100.0), (2.0, 9.5)]


def _k3_keys():
    keys = [trandom.PRNGKey(s, "cpu") for s in K3_SEEDS]
    return keys + [trandom.split_twin(keys[1], 3)[2]]


@pytest.mark.cuda
@pytest.mark.parametrize("num", [1, 2, 3, 7, 1000])
def test_k3_split_bitwise_vs_twin(cuda, num):
    for key in _k3_keys():
        before = trandom.split.launches
        got = trandom.split(key.to(cuda), num)
        assert trandom.split.launches == before + 1
        assert got.dtype == torch.int64 and got.shape == (num, 2) and got.is_cuda
        assert torch.equal(got.cpu(), trandom.split_twin(key, num))


@pytest.mark.cuda
@pytest.mark.parametrize("data", [0, 1, 2**31, 2**32 - 1])
def test_k3_fold_in_bitwise_vs_twin(cuda, data):
    for key in _k3_keys():
        got = trandom.fold_in(key.to(cuda), data)
        assert got.dtype == torch.int64 and got.shape == (2,)
        assert torch.equal(got.cpu(), trandom.fold_in_twin(key, data))


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", K3_RANGES)
@pytest.mark.parametrize("shape", K3_SHAPES, ids=str)
def test_k3_uniform_bitwise_vs_twin(cuda, shape, lo, hi):
    """Every bit of every draw, as int32 views (0.0 and -0.0 differ)."""
    keys = _k3_keys()
    for key in keys if np.prod(shape) < 10**6 else keys[1:3]:
        got = trandom.uniform(key.to(cuda), shape, lo, hi)
        assert got.dtype == torch.float32 and got.shape == shape
        want = trandom.uniform_twin(key, shape, lo, hi)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
        if got.numel():
            assert lo <= got.min().item() and got.max().item() <= hi


@pytest.mark.cuda
def test_k3_key_chain_like_the_optimizer(cuda):
    """The chain mst_pms_optimize and make_candidate_fn walk on the card:
    split, per-iteration split, split in 3, fold_in, split, uniform."""
    k, kt = trandom.PRNGKey(3, cuda), trandom.PRNGKey(3, "cpu")
    k, _ = trandom.split(k)
    kt, _ = trandom.split_twin(kt)
    for ki, kti in zip(trandom.split(k, 4), trandom.split_twin(kt, 4)):
        ka, kb, kc = trandom.split(ki, 3)
        kta, ktb, ktc = trandom.split_twin(kti, 3)
        for j in range(2):
            k1, k2 = trandom.split(trandom.fold_in(ka, j))
            kt1, kt2 = trandom.split_twin(trandom.fold_in_twin(kta, j))
            for a, b in ((k1, kt1), (k2, kt2)):
                assert torch.equal(trandom.uniform(a, (15731,)).cpu(),
                                   trandom.uniform_twin(b, (15731,)))
        assert torch.equal(trandom.uniform(kb, (15731,)).cpu(), trandom.uniform_twin(ktb, (15731,)))
        r = trandom.uniform(trandom.fold_in(kc, 2), (4, 15731), -1.0, 1.0)
        rt = trandom.uniform_twin(trandom.fold_in_twin(ktc, 2), (4, 15731), -1.0, 1.0)
        assert torch.equal(r.cpu(), rt)


_K3_CALLS = """
from stereomatch_tpu_torch import random as trandom
key = trandom.split(trandom.PRNGKey(7, "cuda"), 3)[1]
calls = [lambda: trandom.split(key), lambda: trandom.split(key, 1000),
         lambda: trandom.fold_in(key, 2**32 - 1), lambda: trandom.uniform(key, (15731,)),
         lambda: trandom.uniform(key, (4, 15731), -1.0, 1.0),
         lambda: trandom.uniform(key, (3145728,))]
"""


@pytest.mark.cuda
def test_k3_one_kernel_per_call_and_no_sync(cuda):
    """Each split, fold_in or uniform on a CUDA key is one device kernel
    (the output is allocated, never filled) and makes no host sync."""
    for names in _kernels_a_call(_K3_CALLS):
        assert len(names) == 1 and "threefry_kernel" in names[0], names
    scope = {}
    exec(_K3_CALLS, scope)
    for fn in scope["calls"]:
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in scope["calls"]:
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_k3_wrapper_rejects(cuda):
    key = trandom.PRNGKey(1, cuda)
    for bad in (key.int(), key[:1], torch.zeros((2, 2), dtype=torch.int64, device=cuda)):
        with pytest.raises(TypeError):
            trandom.split(bad)
        with pytest.raises(TypeError):
            trandom.uniform(bad, (3,))
    assert trandom.uniform(key, (0, 5)).shape == (0, 5)
    assert trandom.split(key, 0).shape == (0, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("reuse_forest", [False, True])
def test_video_temporal_frame_launches_k2_only(cuda, reuse_forest):
    """A temporal frame of the video server runs no SGBM, so K1 is not
    launched; its 2 views x (1 seed tree filter + 2 iterations) x 4 scans
    launch K2 24 times: 12 node-order scans and 12 fused ancestor sums. On
    the chained forests (reuse_forest) the frame enqueues without a host
    sync."""
    from stereomatch_tpu_torch.config import production_mst_config
    from stereomatch_tpu_torch.serving import compile_mst_video_server
    from stereomatch_tpu_torch.synthetic import render_sequence

    h, w, d = 120, 160, 24
    seq = render_sequence(2, 2, h, w, d)
    cfg = production_mst_config(d, min_cc_size=100, c=2000.0, forest_backend="device")
    srv = compile_mst_video_server(h, w, cfg=cfg, device=cuda, reuse_forest=reuse_forest,
                                   volume_guided=not reuse_forest)
    srv.collect(srv.submit_pair(seq[0].left, seq[0].right))  # the keyframe
    k1, k2, k2a = aggregate_8path_cuda.launches, segmented_cumsum.launches, ancestor_sums.launches
    torch.cuda.synchronize()
    if reuse_forest:
        torch.cuda.set_sync_debug_mode("error")
    try:
        t = srv.submit_pair(seq[1].left, seq[1].right)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not srv._queue[-1].is_key
    dl, dr = srv.collect(t)
    assert aggregate_8path_cuda.launches == k1
    assert (segmented_cumsum.launches - k2, ancestor_sums.launches - k2a) == (12, 12)
    assert dl.shape == (h, w) and np.isfinite(dl).all() and np.isfinite(dr).all()


@pytest.mark.cuda
def test_patchmatch_on_card_repeats_and_tracks_cpu(cuda):
    """PatchMatch (no hand kernel; plain ops on the card) at 48x64: two runs
    from one key give bit-equal planes (no atomics on the path), the rounds
    enqueue without a host sync, and the card's run agrees with the CPU's
    from the same key within 0.1 px on >= 95% of pixels (exp, sqrt and the
    division by a scalar round differently on the two devices, which can
    flip a near tie)."""
    from stereomatch_tpu_torch import random as trandom
    from stereomatch_tpu_torch.config import PatchMatchConfig
    from stereomatch_tpu_torch.ops.patchmatch import patchmatch_stereo
    from stereomatch_tpu_torch.synthetic import render_scene

    sc = render_scene(0, 48, 64, 16)
    cfg = PatchMatchConfig(max_disp=16.0, window_size=15, tap_stride=3, metric="adgrad",
                           iterations=2)

    def run(dev):
        l = torch.from_numpy(sc.left.astype(np.float32)).to(dev)
        r = torch.from_numpy(sc.right.astype(np.float32)).to(dev)
        key = trandom.PRNGKey(0, dev)
        torch.cuda.synchronize()
        if dev == cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            left, right, _, _ = patchmatch_stereo(key, l, r, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return [t.cpu().numpy() for t in (*left, *right)]

    a, b, host = run(cuda), run(cuda), run(torch.device("cpu"))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for i in (2, 5):  # the disparity maps of both views
        assert np.mean(np.abs(a[i] - host[i]) <= 0.1) >= 0.95


@pytest.mark.cuda
def test_stereo_test_app_on_card_tracks_cpu(cuda, tmp_path):
    """apps.stereo_test.run on the card (K1 once) against the same run on
    the CPU (K1's twin), on files written under the FLIR names with an
    identity rig: the maps agree within 1e-3 px on >= 99% of pixels (float
    luma costs, which K1 sums in any order and the card's cumsums in
    another), the reprojections where the maps are equal within 1e-6, and
    both runs write the same two files."""
    import os

    from chip_smoke import identity_calibration, write_calibration, write_frame_pair
    from stereomatch_tpu_torch.apps import stereo_test
    from stereomatch_tpu_torch.synthetic import render_scene

    sc = render_scene(0, 96, 144, 32)
    data = str(tmp_path)
    write_frame_pair(data, 20, sc.left[:, :128], sc.right[:, 16:])
    cal = os.path.join(data, "rig.yml")
    write_calibration(cal, **identity_calibration(96, 128))
    k1 = aggregate_8path_cuda.launches
    got, got_xyz = stereo_test.run(data, 20, cal, str(tmp_path / "card"), num_disp_factor=2,
                                   verbose=False, device=cuda)
    assert aggregate_8path_cuda.launches - k1 == 1
    want, want_xyz = stereo_test.run(data, 20, cal, str(tmp_path / "cpu"), num_disp_factor=2,
                                     verbose=False, device="cpu")
    assert aggregate_8path_cuda.launches - k1 == 1
    assert got.shape == want.shape == (96, 128)
    assert np.mean(np.abs(got - want) <= 1e-3) >= 0.99
    same = got == want
    np.testing.assert_allclose(got_xyz[same], want_xyz[same], rtol=1e-6, atol=1e-6)
    assert sorted(os.listdir(tmp_path / "card")) == sorted(os.listdir(tmp_path / "cpu"))
