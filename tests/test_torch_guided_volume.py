"""The pair server's default volume: the adgrad volume of each view
guided-filtered with its gray image as guide (`apps/stereo_yin.py::
builtin_cost_volumes`, `ops/filters.py::guided_filter_volume`).

The port is held bit for bit to the benchmark's frozen copy
(`portbench/reference/guided.py`), which decides the cell
`mst_pairs_guided`'s `correct`, and both are held to a float64 guided
filter whose window sums are direct 19x19 sums (a convolution with zero
padding), not cumsum differences. D = 100 leaves a ragged last slab of 4
slices; D = 16 is one slab.

The file imports neither jax nor anything from conftest.
"""

import pathlib
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
from stereomatch_tpu_torch.ops.filters import guided_filter_volume  # noqa: E402
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
    k = torch.ones(1, 1, 2 * r + 1, 2 * r + 1, dtype=x.dtype)
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
