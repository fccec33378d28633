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
the sum). K2 agrees with its twin to rtol 1e-5 / atol 1e-4: both use the
same 256-element blocks but sum in different orders.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereomatch_tpu_torch.ops.mst_scan_cuda import segmented_cumsum, segmented_cumsum_twin
from stereomatch_tpu_torch.ops.sgbm import aggregate_8path
from stereomatch_tpu_torch.ops.sgbm_cuda import aggregate_8path_cuda

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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,mean_seg,k", [(1000, 7, 1), (100000, 40, 7), (300000, 5000, 7), (257, 3, 2), (256, 256, 3)]
)
def test_k2_vs_twin(cuda, m, mean_seg, k):
    rng = np.random.default_rng(1)
    reset = rng.random(m) < 1.0 / mean_seg
    reset[0] = True
    reset = torch.from_numpy(reset)
    x = torch.from_numpy((rng.random((k, m)) - 0.3).astype(np.float32))
    before = segmented_cumsum.launches
    got = segmented_cumsum(x.to(cuda), reset.to(cuda))
    assert segmented_cumsum.launches == before + 1
    torch.testing.assert_close(got.cpu(), segmented_cumsum_twin(x, reset), rtol=1e-5, atol=1e-4)


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


_NVCC_ROUTE = """
import sys
import numpy as np, torch
from pathlib import Path
from stereomatch_tpu_torch import _build
from stereomatch_tpu_torch.ops.mst_scan_cuda import segmented_cumsum, segmented_cumsum_twin
from stereomatch_tpu_torch.ops.sgbm import aggregate_8path
from stereomatch_tpu_torch.ops.sgbm_cuda import aggregate_8path_cuda
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
assert (aggregate_8path_cuda.launches, segmented_cumsum.launches) == (1, 1)
"""


@pytest.mark.cuda
def test_nvcc_route_builds_both_kernels(cuda, tmp_path):
    """The build route taken where ninja is missing: one nvcc command. In a
    fresh process (one extension module of a name per process), both
    wrappers run on the module it builds and agree with their twins."""
    out = subprocess.run([sys.executable, "-c", _NVCC_ROUTE, str(tmp_path)],
                         capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.mark.cuda
@pytest.mark.parametrize("reuse_forest", [False, True])
def test_video_temporal_frame_launches_k2_only(cuda, reuse_forest):
    """A temporal frame of the video server runs no SGBM, so K1 is not
    launched; its 2 views x (1 seed tree filter + 2 iterations) x 4 scans
    launch K2 24 times. On the chained forests (reuse_forest) the frame
    enqueues without a host sync."""
    from stereomatch_tpu_torch.config import production_mst_config
    from stereomatch_tpu_torch.serving import compile_mst_video_server
    from stereomatch_tpu_torch.synthetic import render_sequence

    h, w, d = 120, 160, 24
    seq = render_sequence(2, 2, h, w, d)
    cfg = production_mst_config(d, min_cc_size=100, c=2000.0, forest_backend="device")
    srv = compile_mst_video_server(h, w, cfg=cfg, device=cuda, reuse_forest=reuse_forest,
                                   volume_guided=not reuse_forest)
    srv.collect(srv.submit_pair(seq[0].left, seq[0].right))  # the keyframe
    k1, k2 = aggregate_8path_cuda.launches, segmented_cumsum.launches
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
    assert segmented_cumsum.launches - k2 == 24
    assert dl.shape == (h, w) and np.isfinite(dl).all() and np.isfinite(dr).all()
