"""The benchmark's torch renderer against the program's numpy renderer
(`stereomatch_tpu_torch.synthetic`), at a small size on the CPU. The
scene parameters come from the same numpy draws; the per-pixel float64
arithmetic is the same but for the order of the sum over a texture's
sinusoids, so images agree to 1e-3 of a grey level and the ground truth
and masks exactly."""

import numpy as np
import pytest

from portbench.traffic.render import render_scene, render_sequence, scene_eval_mask
from stereomatch_tpu_torch import synthetic


def _same(got, want):
    np.testing.assert_allclose(got.left, want.left, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.right, want.right, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.disp_left, want.disp_left)
    np.testing.assert_array_equal(got.occ_left, want.occ_left)
    assert got.max_disp == want.max_disp
    np.testing.assert_array_equal(scene_eval_mask(got), synthetic.scene_eval_mask(want))


@pytest.mark.parametrize("seed,shape", [(0, (48, 64, 16)), (7, (60, 96, 24)),
                                        ([3, 1], (40, 120, 32))])
def test_scene_matches_the_programs_renderer(seed, shape):
    _same(render_scene(seed, *shape, device="cpu"), synthetic.render_scene(seed, *shape))


def test_sequence_matches_the_programs_renderer():
    got = render_sequence(5, 4, 48, 80, 16, device="cpu")
    want = synthetic.render_sequence(5, 4, 48, 80, 16)
    for g, w in zip(got, want, strict=True):
        _same(g, w)
    assert not np.array_equal(got[0].disp_left, got[-1].disp_left)  # the discs moved
