"""The port's apps (stereomatch_tpu_torch/apps/: stereo_test, stereo_yin,
stream) against the JAX package's on the same files: synthetic scenes
written as 8-bit PNG under the FLIR cameras' file names in a temporary
directory, and calibrations built from numbers (chip_smoke.py's writers).
The identity rig rectifies every pixel onto itself, so the scene's exact
ground truth holds; the distorted rig (XML) makes the remap warp.

Tolerances, as the port test of each engine holds it: SGBM on float luma
99% of pixels within 1e-4 px; the 3DMST maps 95% within 0.1 px; the
cost-volume stream, which the JAX package runs tiled over a mesh of 8
virtual CPU devices and the port over its process group's ranks (one here,
two in a spawned gloo world), as tests/test_parallel.py holds the tiled
pipeline to the whole frame: at most 1% of pixels differ by more than
0.02 px.

Measured on the CPU: stereo_test within 1.6e-5 px everywhere (91% bit for
bit, identity and distorted rigs); stereo_yin within 4e-4 px on both
routes; the cost-volume stream within 1.9e-5 px; the streaming 3DMST
frames 99.97-100% within 0.1 px (at most 0.17 px apart).
"""

import os

import numpy as np
import pytest
import torch

import torch_mesh_ranks
from chip_smoke import (
    distorted_calibration, identity_calibration, write_calibration, write_frame_pair,
)
from stereomatch_tpu.apps import stereo_test as jst
from stereomatch_tpu.apps import stereo_yin as jsy
from stereomatch_tpu.apps import stream as jstream
from stereomatch_tpu_torch.apps import stereo_test as tst
from stereomatch_tpu_torch.apps import stereo_yin as tsy
from stereomatch_tpu_torch.apps import stream as tstream
from stereomatch_tpu_torch.eval import disparity_metrics
from stereomatch_tpu_torch.io import save_mccnn_volume
from stereomatch_tpu_torch.parallel.launch import spawn
from stereomatch_tpu_torch.synthetic import render_scene, render_sequence, scene_eval_mask


def _share(a, b, tol):
    return float(np.mean(np.abs(a - b) <= tol))


def _rig(d, h, w):
    """The identity rig as YAML and the distorted one as XML, for h x w."""
    paths = os.path.join(d, "identity.yml"), os.path.join(d, "distorted.xml")
    write_calibration(paths[0], **identity_calibration(h, w))
    write_calibration(paths[1], **distorted_calibration(h, w))
    return paths


@pytest.fixture(scope="module")
def sgbm_frame(tmp_path_factory):
    """Frame 20, 96x128, with every disparity inside stereo_test's search
    range [16, 48): a 96x144 scene with disparities in [2, 30], the right
    view taken 16 columns further right, so each disparity grows by 16."""
    d = str(tmp_path_factory.mktemp("stereo_test"))
    sc = render_scene(0, 96, 144, 32)
    write_frame_pair(d, 20, sc.left[:, :128], sc.right[:, 16:])
    gt = sc.disp_left[:, :128] + 16.0
    scored = scene_eval_mask(sc)[:, :128] & (np.arange(128) - gt >= 0)
    return d, gt, scored, *_rig(d, 96, 128)


@pytest.mark.parametrize("rig", ["identity", "distorted"])
def test_stereo_test_matches_jax(sgbm_frame, tmp_path, rig):
    """rectify -> SGBM (min_disp 16, 32 disparities) -> reproject -> PCD."""
    d, gt, scored, ident, dist = sgbm_frame
    cal = ident if rig == "identity" else dist
    got, got_xyz = tst.run(d, 20, cal, str(tmp_path / "t"), num_disp_factor=2, verbose=False,
                           device="cpu")
    want, want_xyz = jst.run(d, 20, cal, str(tmp_path / "j"), num_disp_factor=2, verbose=False)
    assert got.dtype == np.float32 and got.shape == (96, 128) and got_xyz.shape == (96, 128, 3)
    assert _share(got, want, 1e-4) >= 0.99
    same = got == want
    np.testing.assert_allclose(got_xyz[same], want_xyz[same], rtol=1e-6, atol=1e-6)
    for tag in ("t", "j"):
        files = sorted(os.listdir(tmp_path / tag))
        assert files == ["cloud_000020.pcd", "disp_000020.png"], files
    if rig == "identity":  # the scene's exact GT holds through the identity rig
        valid = (got >= 16) & scored
        mm = disparity_metrics(torch.from_numpy(got), torch.from_numpy(gt),
                               torch.from_numpy(valid))
        assert valid.mean() > 0.5 and mm["epe"] < 0.5 and mm["bad2"] < 0.05, (valid.mean(), mm)


@pytest.fixture(scope="module")
def mst_frame(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("stereo_yin"))
    sc = render_scene(1, 48, 64, 16)
    write_frame_pair(d, 21, sc.left, sc.right)
    return d, _rig(d, 48, 64)[0]


def test_stereo_yin_builtin_and_mccnn_routes(mst_frame, tmp_path):
    """The built-in volumes and the mc-cnn route on the same volumes,
    written with save_mccnn_volume: each against the JAX app, and the port's
    two routes bit-equal (the volumes read back equal; clean_mccnn leaves
    [0, 0.5] costs as they are)."""
    torch.set_num_threads(1)
    d, cal = mst_frame
    kw = dict(max_disp=16, iterations=4, verbose=False)
    got, got_xyz = tsy.run(d, 21, cal, str(tmp_path / "t"), device="cpu", **kw)
    want, _ = jsy.run(d, 21, cal, str(tmp_path / "j"), **kw)
    assert got.shape == (48, 64) and got_xyz.shape == (48, 64, 3) and got.min() >= 10.0
    assert _share(got, want, 0.1) >= 0.95
    assert sorted(os.listdir(tmp_path / "t")) == ["mst_cloud_000021.ply", "mst_disp_000021.png"]

    left, right = tst.load_pair(d, 21)
    lv, rv = tsy.builtin_cost_volumes(torch.from_numpy(left), torch.from_numpy(right), 16)
    mc = tmp_path / "mccnn"
    mc.mkdir()
    save_mccnn_volume(str(mc / "left.bin"), lv)
    save_mccnn_volume(str(mc / "right.bin"), rv)
    got_mc, _ = tsy.run(d, 21, cal, str(tmp_path / "tm"), mccnn_dir=str(mc), device="cpu", **kw)
    want_mc, _ = jsy.run(d, 21, cal, str(tmp_path / "jm"), mccnn_dir=str(mc), **kw)
    np.testing.assert_array_equal(got_mc, got)
    assert _share(got_mc, want_mc, 0.1) >= 0.95


@pytest.fixture(scope="module")
def stream_dirs(tmp_path_factory):
    """Two data directories: a smooth 3-frame sequence at 48x64 (ids 20,
    40, 60) and a 2-frame one at 96x128 for the cost-volume stream, whose
    JAX mesh splits 96 rows into 4 tiles (the tiles must outgrow the
    guided filter's halo of 18 rows)."""
    base = tmp_path_factory.mktemp("stream")
    small, large = str(base / "small"), str(base / "large")
    for d, (n, h, w) in ((small, (3, 48, 64)), (large, (2, 96, 128))):
        os.makedirs(d)
        for fid, sc in zip((20, 40, 60), render_sequence(0, n, h, w, 16)):
            write_frame_pair(d, fid, sc.left, sc.right)
        _rig(d, h, w)
    return small, large


def test_stream_run_matches_jax_by_share(stream_dirs, tmp_path):
    _, d = stream_dirs
    cal = os.path.join(d, "identity.yml")
    got = tstream.run(d, cal, str(tmp_path / "t"), ids=(20, 40), scale=1.0, max_disp=15,
                      verbose=False, device="cpu")
    want = jstream.run(d, cal, str(tmp_path / "j"), ids=(20, 40), scale=1.0, max_disp=15,
                       verbose=False)
    assert got.shape == want.shape == (2, 96, 128) and np.isfinite(got).all()
    assert np.mean(np.abs(got - want) > 0.02) <= 0.01
    assert sorted(os.listdir(tmp_path / "t")) == ["stream_disp_000020.png",
                                                  "stream_disp_000040.png"]
    again = tstream.run(d, cal, str(tmp_path / "t"), ids=(20, 40), scale=1.0, max_disp=15,
                        verbose=False, resume=True, device="cpu")
    assert again.size == 0  # every frame done: nothing recomputed


def test_stream_run_on_two_ranks_matches_one(stream_dirs, tmp_path):
    """stream.run on a spawned 2-rank gloo world (frame 1 x tile 2: two row
    tiles of 48 rows with their halos) against its run alone (one tile),
    held as tests/test_parallel.py holds the tiled pipeline to the whole
    frame: at most 1% of pixels beyond 0.02 px. Both ranks return the
    maps; rank 0 alone writes them. The world's deadline is 120 s."""
    _, d = stream_dirs
    cal = os.path.join(d, "identity.yml")
    kw = dict(ids=(20, 40), scale=1.0, max_disp=15, verbose=False)
    one = tstream.run(d, cal, str(tmp_path / "one"), device="cpu", **kw)
    world = spawn(torch_mesh_ranks.stream_world, 2, d, cal, str(tmp_path / "two"), kw,
                  timeout=120.0)
    two = world["dl"].numpy()
    assert int(world["ranks/dl"]) == 2
    assert two.shape == one.shape == (2, 96, 128) and np.isfinite(two).all()
    assert np.mean(np.abs(two - one) > 0.02) <= 0.01
    assert sorted(os.listdir(tmp_path / "two")) == ["stream_disp_000020.png",
                                                    "stream_disp_000040.png"]


@pytest.mark.parametrize("mode", ["host", "video_device"])
def test_stream_run_mst_matches_jax(stream_dirs, tmp_path, mode):
    """The flat streaming 3DMST on the host forest, and video mode (SGBM
    keyframe, then temporal frames seeded from the last maps) on the device
    forest with scene cuts armed; then resume skips every frame."""
    torch.set_num_threads(1)
    d, _ = stream_dirs
    cal = os.path.join(d, "identity.yml")
    kw = dict(ids=(20, 40, 60), scale=1.0, max_disp=16, iterations=2, verbose=False)
    if mode == "video_device":
        kw.update(sgbm_seed=True, temporal_reseed=0, forest_backend="device",
                  scene_cut_ratio=0.6)
    got, waits = tstream.run_mst(d, cal, str(tmp_path / "t"), device="cpu", **kw)
    want, _ = jstream.run_mst(d, cal, str(tmp_path / "j"), **kw)
    assert got.shape == want.shape == (3, 48, 64) and len(waits) == 3
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 16.0
    for g, w in zip(got, want):
        assert _share(g, w, 0.1) >= 0.95
    assert len(os.listdir(tmp_path / "t")) == 3
    again, waits = tstream.run_mst(d, cal, str(tmp_path / "t"), device="cpu",
                                   **{**kw, "resume": True})
    assert again.size == 0 and waits == []


def test_stream_run_mst_scene_cut_reseeds(tmp_path, capsys):
    """Video mode on a hard cut (frame 40 is another scene): with a near-1
    threshold the temporal frame is redone as a keyframe, in both apps."""
    torch.set_num_threads(1)
    d = str(tmp_path / "data")
    os.makedirs(d)
    for fid, seed in ((20, 0), (40, 5)):
        sc = render_scene(seed, 48, 64, 16)
        write_frame_pair(d, fid, sc.left, sc.right)
    cal = _rig(d, 48, 64)[0]
    kw = dict(ids=(20, 40), scale=1.0, max_disp=16, iterations=2, verbose=True, sgbm_seed=True,
              temporal_reseed=0, scene_cut_ratio=0.98)
    got, _ = tstream.run_mst(d, cal, str(tmp_path / "t"), device="cpu", **kw)
    out_t = capsys.readouterr().out
    want, _ = jstream.run_mst(d, cal, str(tmp_path / "j"), **kw)
    out_j = capsys.readouterr().out
    for out in (out_t, out_j):
        assert "scene cuts (reseeded frames): 000040" in out, out[-500:]
    for g, w in zip(got, want):
        assert _share(g, w, 0.1) >= 0.95
