"""The pair server's default volume: the adgrad volume of each view
guided-filtered with its gray image as guide (`apps/stereo_yin.py::
builtin_cost_volumes`, `ops/filters.py::guided_filter_volume`).

The port is held bit for bit to the benchmark's frozen copy
(`portbench/reference/guided.py`), which decides the cell
`mst_pairs_guided`'s `correct`, and both are held to a float64 guided
filter whose window sums are direct 19x19 sums (a convolution with zero
padding), not cumsum differences. D = 100 leaves a ragged last slab of 4
slices; D = 16 is one slab.

On a CUDA device `guided_filter_volume` is kernel K4, one launch a view;
the tests marked `cuda` hold it to the same float64 filter (within
ATOL_COST at the rig's full 1536x2048x100 and at ragged shapes) and to its
twin, and skip without a card. The file imports neither jax nor anything
from conftest, so it runs on a GPU machine without jax:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_guided_volume.py -q
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import guided as ref  # noqa: E402
from stereomatch_tpu_torch.apps.stereo_yin import builtin_cost_volumes  # noqa: E402
from stereomatch_tpu_torch.config import CostVolumeConfig, GuidedFilterConfig  # noqa: E402
from stereomatch_tpu_torch.ops.cost import adgrad_bgr_volumes, bgr_to_gray  # noqa: E402
from stereomatch_tpu_torch.ops.filters import (  # noqa: E402
    guided_filter_volume, guided_filter_volume_twin,
)
from stereomatch_tpu_torch.synthetic import render_scene  # noqa: E402

H, W = 36, 120
G = GuidedFilterConfig()
GUIDED = {"radius": G.radius, "eps": G.eps, "slab": G.slab}

# float32 window sums are cumsum differences, so they round with the length
# of the running sum: on costs in [0, 3] the largest error against float64
# was 8.6e-5 at the rig's 1536x2048 (p99 2.2e-5). 1e-4 holds that width;
# this size lies well inside it, and a wrong eps, radius or slab moves the
# result by orders of magnitude more
ATOL_COST = 1e-4


def _bgr_pair(d: int, seed: int = 5):
    sc = render_scene(seed, H, W, d)
    return (torch.from_numpy(np.ascontiguousarray(sc.left)).float(),
            torch.from_numpy(np.ascontiguousarray(sc.right)).float())


def _box_direct(x: torch.Tensor, r: int) -> torch.Tensor:
    """Zero-padded (2r+1)^2 window mean of (H, W, K) float64, as direct sums."""
    k = torch.ones(1, 1, 2 * r + 1, 2 * r + 1, dtype=x.dtype, device=x.device)
    s = F.conv2d(x.permute(2, 0, 1)[:, None], k, padding=r)[:, 0].permute(1, 2, 0)
    return s / float((2 * r + 1) ** 2)


def _guided_direct(guide: torch.Tensor, vol: torch.Tensor, r: int, eps: float) -> torch.Tensor:
    """He et al.'s gray guided filter of every slice, float64, direct sums."""
    g = guide.double()[..., None]
    p = vol.double()
    mean_g = _box_direct(g, r)
    var_g = _box_direct(g * g, r) - mean_g * mean_g
    mean_p = _box_direct(p, r)
    a = (_box_direct(g * p, r) - mean_g * mean_p) / (var_g + eps)
    b = mean_p - a * mean_g
    return _box_direct(a, r) * g + _box_direct(b, r)


@pytest.mark.parametrize("d", [100, 16])
def test_port_volumes_equal_the_benchmarks_frozen_copy_bit_for_bit(d):
    bl, br = _bgr_pair(d)
    got = builtin_cost_volumes(bl.flip(-1), br.flip(-1), d, guided=True)
    want = ref.guided_volumes(bl, br, d, GUIDED)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype == torch.float32 and g.shape == (H, W, d)
        assert torch.equal(g, w)
    # and the filter did work: the guided volume is not the raw one
    raw = builtin_cost_volumes(bl.flip(-1), br.flip(-1), d, guided=False)
    assert (got[0] - raw[0]).abs().max() > 1e-2


@pytest.mark.parametrize("impl", ["port", "reference"])
@pytest.mark.parametrize("d", [100, 16])
def test_guided_filter_matches_direct_window_sums_in_float64(impl, d):
    bl, br = _bgr_pair(d, seed=11)
    vols = adgrad_bgr_volumes(bl, br, CostVolumeConfig(min_disp=0, max_disp=d - 1))
    fn = guided_filter_volume if impl == "port" else ref.guided_filter_volume
    for bgr, vol in zip((bl, br), vols):
        guide = bgr_to_gray(bgr)
        got = fn(guide, vol, G.radius, G.eps, G.slab)
        want = _guided_direct(guide, vol, G.radius, G.eps)
        err = (got.double() - want).abs().max().item()
        assert err <= ATOL_COST, err
        assert want.abs().max() > 0.5  # costs of the scale the tolerance was set on


def test_slabs_do_not_change_the_result():
    """16-slice slabs with a ragged last one equal one slab of all 100."""
    bl, br = _bgr_pair(100)
    vol = adgrad_bgr_volumes(bl, br, CostVolumeConfig(min_disp=0, max_disp=99))[0]
    guide = bgr_to_gray(bl)
    a = guided_filter_volume(guide, vol, G.radius, G.eps, 16)
    b = guided_filter_volume(guide, vol, G.radius, G.eps, 100)
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape,mode", [((36, 120, 100), "zero"), ((9, 7, 13), "zero"),
                                        ((36, 120, 16), "reflect")])
def test_cpu_tensor_runs_the_twin_unchanged(shape, mode):
    """On the CPU the wrapper is its twin, bit for bit, and launches nothing."""
    g = torch.Generator().manual_seed(3)
    guide = torch.rand(shape[:2], generator=g) * 255
    vol = torch.rand(shape, generator=g) * 3
    before = guided_filter_volume.launches
    got = guided_filter_volume(guide, vol, G.radius, G.eps, G.slab, mode)
    assert torch.equal(got, guided_filter_volume_twin(guide, vol, G.radius, G.eps, G.slab, mode))
    assert guided_filter_volume.launches == before


# ---- K4 on the card ----

# the rig's frame; H and W no multiple of the block's 28 columns; D = 16;
# D no multiple of the block's 8 disparities, and no multiple of 4 (the
# 4-byte copy route); images smaller than the 19x19 window; a single row,
# a single column, a pixel; few blocks on many rows (segments of rows)
K4_SHAPES = [(1536, 2048, 100), (45, 83, 100), (64, 57, 16), (33, 40, 13), (20, 30, 4),
             (7, 11, 100), (1, 70, 12), (50, 1, 8), (1, 1, 16), (300, 30, 8), (257, 61, 24)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU mode")
    # no TF32 in the float64 reference's convolutions or anywhere else
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _k4_inputs(shape, dev):
    """The rig's frame: a scene's adgrad volume and gray guide; smaller
    shapes: a uniform guide in [0, 255] and costs in [0, 3]."""
    h, w, d = shape
    if shape == K4_SHAPES[0]:
        sc = render_scene(5, h, w, d)
        bl, br = (torch.from_numpy(np.ascontiguousarray(x)).float().to(dev)
                  for x in (sc.left, sc.right))
        vol = adgrad_bgr_volumes(bl, br, CostVolumeConfig(min_disp=0, max_disp=d - 1))[0]
        return bgr_to_gray(bl), vol
    g = torch.Generator().manual_seed(h * 1000 + w + d)
    return ((torch.rand((h, w), generator=g) * 255).to(dev),
            (torch.rand(shape, generator=g) * 3).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K4_SHAPES, ids=str)
def test_k4_matches_direct_window_sums_in_float64(cuda, shape):
    guide, vol = _k4_inputs(shape, cuda)
    got = guided_filter_volume(guide, vol, G.radius, G.eps, G.slab)
    want = _guided_direct(guide, vol, G.radius, G.eps)
    err = (got.double() - want).abs().max().item()
    assert err <= ATOL_COST, err
    if min(shape[:2]) > 2 * G.radius:  # windows inside the image: costs at full scale
        assert want.abs().max() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [K4_SHAPES[0], (45, 83, 100), (33, 40, 13), (257, 61, 24)],
                         ids=str)
def test_k4_matches_its_twin_and_repeats(cuda, shape):
    """Within ATOL_COST of its eager twin run in float64, and of the float32
    twin below the rig's size, and bit for bit the same on a second call (no
    atomics, a fixed order of sums). At the rig's size the float32 twin's own
    cumsum differences round by up to 8.6e-5, so two float32 filters may
    differ by more than either does from the exact one: there K4 is held to
    the twin's arithmetic in float64."""
    guide, vol = _k4_inputs(shape, cuda)
    got = guided_filter_volume(guide, vol, G.radius, G.eps, G.slab)
    exact = guided_filter_volume_twin(guide.double(), vol.double(), G.radius, G.eps, G.slab)
    assert (got.double() - exact).abs().max().item() <= ATOL_COST
    del exact
    if shape != K4_SHAPES[0]:
        twin = guided_filter_volume_twin(guide, vol, G.radius, G.eps, G.slab)
        assert (got - twin).abs().max().item() <= ATOL_COST
    assert torch.equal(got, guided_filter_volume(guide, vol, G.radius, G.eps, G.slab))


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [0, 1, 4])
def test_k4_other_radii_match_the_twin(cuda, radius):
    guide, vol = _k4_inputs((70, 95, 20), cuda)
    got = guided_filter_volume(guide, vol, radius, G.eps)
    twin = guided_filter_volume_twin(guide.double(), vol.double(), radius, G.eps)
    assert (got.double() - twin).abs().max().item() <= ATOL_COST


@pytest.mark.cuda
def test_k4_one_launch_a_view(cuda):
    bl, br = (x.to(cuda) for x in _bgr_pair(100))
    before = guided_filter_volume.launches
    got = builtin_cost_volumes(bl.flip(-1), br.flip(-1), 100, guided=True)
    assert guided_filter_volume.launches == before + 2
    builtin_cost_volumes(bl.flip(-1), br.flip(-1), 100, guided=False)
    assert guided_filter_volume.launches == before + 2
    # and the card's volumes track the CPU's: the same mathematics, float32 rounding
    want = builtin_cost_volumes(bl.cpu().flip(-1), br.cpu().flip(-1), 100, guided=True)
    for g, w in zip(got, want, strict=True):
        assert (g.cpu() - w).abs().max().item() <= ATOL_COST


_K4_PROFILE = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from stereomatch_tpu_torch.ops.filters import guided_filter_volume
dev = torch.device("cuda")
g = torch.rand((70, 95), device=dev) * 255
v = torch.rand((70, 95, 100), device=dev) * 3
guided_filter_volume(g, v, 9, 6.5025)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    guided_filter_volume(g, v, 9, 6.5025)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


@pytest.mark.cuda
def test_k4_one_device_kernel_a_call(cuda):
    """One device kernel a call, no memset or copy beside it, counted by
    torch.profiler in a fresh process (a short trace late in a long process
    has held no device event on the H100)."""
    out = subprocess.run([sys.executable, "-c", _K4_PROFILE], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(names) == 1 and "guided_filter_kernel" in names[0], names


@pytest.mark.cuda
def test_k4_wrapper_rejects(cuda):
    guide, vol = _k4_inputs((20, 30, 8), cuda)
    with pytest.raises(ValueError, match="zero padding"):
        guided_filter_volume(guide, vol, G.radius, G.eps, mode="reflect")
    with pytest.raises(ValueError, match="radius"):
        guided_filter_volume(guide, vol, 10, G.eps)
    with pytest.raises(TypeError):
        guided_filter_volume(guide, vol.double(), G.radius, G.eps)
    with pytest.raises(ValueError, match="contiguous"):
        guided_filter_volume(guide, vol.transpose(0, 1).contiguous().transpose(0, 1), G.radius,
                             G.eps)
    with pytest.raises(ValueError, match="guide"):
        guided_filter_volume(guide[:, :-1].contiguous(), vol, G.radius, G.eps)
    with pytest.raises(ValueError, match="on"):
        guided_filter_volume(guide.cpu(), vol, G.radius, G.eps)
