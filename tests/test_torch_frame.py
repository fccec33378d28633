"""The SGBM-seeded 3DMST frame that the servers share
(stereomatch_tpu_torch/models/sgbm_mst.py::SeededMSTFrame), on the CPU at
48x64x16: the pair server's frame and the keyframes of both video servers
are one frame; the temporal frame on kept forests equals the temporal frame
that builds them again; and the refine swapped as portbench/faults.py plants
it reaches every frame of a server built before the swap."""

import numpy as np
import pytest
import torch

from portbench.faults import plant
from stereomatch_tpu_torch.config import production_mst_config
from stereomatch_tpu_torch.serving import compile_mst_video_server, compile_sgbm_mst_server

H, W, D = 48, 64, 16
CFG = production_mst_config(D, on_tpu=False, min_cc_size=20, c=800.0, forest_backend="device")
KW = dict(cfg=CFG, fine_iterations=1, volume_guided=False, device="cpu")
KINDS = ("pair", "video_rebuild", "video_reuse")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    img = (rng.random((H, W, 3)) * 255).astype(np.float32)
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    return img, np.roll(img, -3, axis=1)


def _server(kind):
    if kind == "pair":
        return compile_sgbm_mst_server(H, W, **KW)
    return compile_mst_video_server(H, W, temporal_iterations=1,
                                    reuse_forest=kind == "video_reuse", **KW)


def _serve(srv, pair, frames):
    """The maps of `frames` submissions of the same pair, keyed 0, 1, ...:
    a keyframe, then (video) a temporal frame."""
    tickets = [srv.submit_pair(*pair, seed=i) for i in range(frames)]
    return [srv.collect(t) for t in tickets]


@pytest.fixture(scope="module")
def clean(pair):
    return {k: _serve(_server(k), pair, 1 if k == "pair" else 2) for k in KINDS}


def _assert_maps_equal(got, want):
    for g, w_ in zip(got, want, strict=True):
        assert g.shape == (H, W) and np.isfinite(g).all()
        np.testing.assert_array_equal(g, w_)


def test_reuse_keyframe_equals_rebuild_keyframe(clean):
    """Building both forests before the refines (reuse_forest) or each just
    before its refine is the same frame, and so is the pair server's."""
    _assert_maps_equal(clean["video_reuse"][0], clean["video_rebuild"][0])
    _assert_maps_equal(clean["video_reuse"][0], clean["pair"][0])


def test_temporal_frame_on_kept_forests_equals_rebuilt(clean):
    """The same pair twice: the temporal frame's chained forests are the
    forests it would build, so its maps are the rebuilt frame's."""
    _assert_maps_equal(clean["video_reuse"][1], clean["video_rebuild"][1])


@pytest.mark.parametrize("kind", KINDS)
def test_refine_swap_reaches_every_frame(pair, clean, kind):
    """`answer_altered` swaps sgbm_mst._refine_view_given_forest after the
    server is built: the keyframe's maps are the clean ones + 1 px, and the
    temporal frame's maps move too."""
    srv = _server(kind)
    undo = plant({"mst": {}}, "answer_altered")
    try:
        faulted = _serve(srv, pair, len(clean[kind]))
    finally:
        undo()
    _assert_maps_equal(faulted[0], [m + 1.0 for m in clean[kind][0]])
    for got, want in zip(faulted[1:], clean[kind][1:]):
        assert all(not np.array_equal(g, w_) for g, w_ in zip(got, want))
