"""The port's file I/O (stereomatch_tpu_torch/io/ and the loaders of
eval.py) against the JAX package's on the same numpy inputs made from a
seed: the calibration parser is a byte copy, held so, and reads the
FileStorage files chip_smoke.py writes (also checked against
cv2.FileStorage); images go through PIL in both packages; the point-cloud
and mc-cnn files are byte-equal to the JAX package's for the same data,
given as tensors to the port."""

import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import stereomatch_tpu.eval as jeval
import stereomatch_tpu.io as jio
import stereomatch_tpu_torch.eval as teval
import stereomatch_tpu_torch.io as tio
from chip_smoke import distorted_calibration, identity_calibration, write_calibration


def _bytes(path):
    return pathlib.Path(path).read_bytes()


def test_calibration_is_a_byte_copy():
    from stereomatch_tpu.io import calibration as jcal
    from stereomatch_tpu_torch.io import calibration as tcal

    assert _bytes(tcal.__file__) == _bytes(jcal.__file__)


def test_io_exports_equal_jax():
    assert tio.__all__ == jio.__all__


@pytest.mark.parametrize("ext", [".yml", ".xml"])
@pytest.mark.parametrize("rig", ["identity", "distorted"])
def test_calibration_round_trip(tmp_path, ext, rig):
    """A calibration built from numbers, written as YAML or XML FileStorage,
    reads back exactly in both packages and in cv2."""
    mats = (identity_calibration if rig == "identity" else distorted_calibration)(1536, 2048)
    path = str(tmp_path / f"cal{ext}")
    write_calibration(path, **mats)
    got, want = tio.load_filestorage(path), jio.load_filestorage(path)
    assert sorted(got) == sorted(mats)
    for k, m in mats.items():
        np.testing.assert_array_equal(got[k].reshape(m.shape), m)
        np.testing.assert_array_equal(got[k], want[k])
    cal = tio.load_stereo_calibration(path)
    assert cal.T.shape == (3,) and cal.Q is None
    cv2 = pytest.importorskip("cv2")
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    try:
        for k, m in mats.items():
            np.testing.assert_array_equal(fs.getNode(k).mat(), m)
    finally:
        fs.release()


@pytest.mark.parametrize("as_tensor", [False, True])
def test_images_save_and_load_equal_jax(tmp_path, rng, as_tensor):
    """save_image rounds and clips to 8 bits; files and loads equal JAX's."""
    img = (rng.random((20, 30, 3)) * 300 - 20).astype(np.float32)
    gray = (rng.random((20, 30)) * 255).astype(np.float32)
    for name, x in (("rgb.png", img), ("gray.png", gray), ("rgb.jpg", img)):
        ours, theirs = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
        tio.save_image(ours, torch.from_numpy(x) if as_tensor else x)
        jio.save_image(theirs, x)
        assert _bytes(ours) == _bytes(theirs)
        for as_gray in (False, True):
            got = tio.load_image(ours, gray=as_gray)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, jio.load_image(theirs, gray=as_gray))


def test_save_disparity_png_from_a_tensor(tmp_path, rng):
    disp = (rng.random((16, 24)) * 40).astype(np.float32)
    for max_disp in (None, 63.0):
        ours, theirs = str(tmp_path / "t.png"), str(tmp_path / "j.png")
        tio.save_disparity_png(ours, torch.from_numpy(disp), max_disp)
        jio.save_disparity_png(theirs, disp, max_disp)
        assert _bytes(ours) == _bytes(theirs)
        assert tio.load_image(ours, gray=True).shape == disp.shape


def test_color_helpers_on_tensors(rng):
    rgb = (rng.random((6, 7, 3)) * 255).astype(np.float32)
    t = torch.from_numpy(rgb)
    np.testing.assert_array_equal(tio.to_gray(t).numpy(), np.asarray(jio.to_gray(jnp.asarray(rgb))))
    np.testing.assert_array_equal(tio.to_gray(rgb), jio.to_gray(rgb))
    np.testing.assert_array_equal(tio.to_planar(t).numpy(), jio.to_planar(rgb))
    np.testing.assert_array_equal(tio.to_planar(rgb), jio.to_planar(rgb))
    np.testing.assert_array_equal(tio.normalize01(t).numpy(),
                                  np.asarray(jio.normalize01(jnp.asarray(rgb))))


@pytest.fixture()
def cloud(rng):
    """An (H, W, 3) reprojection with non-finite, huge and far points."""
    xyz = rng.normal(0.0, 0.5, size=(12, 16, 3)).astype(np.float32)
    xyz[0, :3] = np.inf
    xyz[1, :2, 0] = np.nan
    xyz[2, :4, 2] = 2e4
    rgb = (rng.random((12, 16, 3)) * 270 - 5).astype(np.float32)
    return xyz, rgb


def test_filter_cloud_from_tensors_equals_jax(cloud):
    xyz, rgb = cloud
    for z_max in (None, 0.8):
        pts, cols = tio.filter_cloud(torch.from_numpy(xyz), torch.from_numpy(rgb), z_max=z_max)
        jpts, jcols = jio.filter_cloud(xyz, rgb, z_max=z_max)
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(cols, jcols)
    pts, cols = tio.filter_cloud(xyz)
    assert cols is None and np.isfinite(pts).all() and len(pts) < 12 * 16


@pytest.mark.parametrize("fmt,colored", [("ply", False), ("ply", True), ("pcd", False),
                                         ("pcd", True), ("xyz", False)])
def test_cloud_files_byte_equal_jax(tmp_path, cloud, fmt, colored):
    xyz, rgb = cloud
    pts, cols = jio.filter_cloud(xyz, rgb, z_max=2.0)
    pts[0] = [1e-7, -123.4567891, 3.5]  # rounding edge cases of %.6f
    ours, theirs = str(tmp_path / f"t.{fmt}"), str(tmp_path / f"j.{fmt}")
    if fmt == "xyz":  # no colors
        tio.save_xyz(ours, torch.from_numpy(pts))
        jio.save_xyz(theirs, pts)
    else:
        save_t, save_j = {"ply": (tio.save_ply, jio.save_ply), "pcd": (tio.save_pcd,
                                                                       jio.save_pcd)}[fmt]
        save_t(ours, torch.from_numpy(pts), torch.from_numpy(cols) if colored else None)
        save_j(theirs, pts, cols if colored else None)
    assert _bytes(ours) == _bytes(theirs)
    assert len(_bytes(ours).splitlines()) >= len(pts)


def test_mccnn_round_trip_and_layout(tmp_path, rng):
    h, w, d = 5, 7, 4
    vol = rng.random((h, w, d)).astype(np.float32)
    ours, theirs = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    tio.save_mccnn_volume(ours, torch.from_numpy(vol))
    jio.save_mccnn_volume(theirs, vol)
    assert _bytes(ours) == _bytes(theirs)
    np.testing.assert_array_equal(np.fromfile(ours, np.float32).reshape(d, h, w),
                                  vol.transpose(2, 0, 1))
    got = tio.load_mccnn_volume(ours, h, w, d)
    np.testing.assert_array_equal(got, vol)
    np.testing.assert_array_equal(got, jio.load_mccnn_volume(ours, h, w, d))
    tio.save_mccnn_volume(ours, torch.from_numpy(vol).to(torch.bfloat16))
    np.testing.assert_array_equal(tio.load_mccnn_volume(ours, h, w, d),
                                  torch.from_numpy(vol).to(torch.bfloat16).float().numpy())
    with pytest.raises(ValueError, match="expected"):
        tio.load_mccnn_volume(ours, h, w, d + 1)


@pytest.mark.parametrize("arch", ["acrt", "fast"])
def test_clean_mccnn_and_ambiguity(rng, arch):
    vol = (rng.random((6, 8, 5)) * 2 - (1 if arch == "fast" else 0)).astype(np.float32)
    vol[0, :3, 1] = np.nan
    want = jio.clean_mccnn(vol, arch=arch)
    got = tio.clean_mccnn(vol, arch=arch)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    got_t = tio.clean_mccnn(torch.from_numpy(vol), arch=arch)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(jio.clean_mccnn(jnp.asarray(vol),
                                                                            arch=arch)))
    assert np.isfinite(got).all() and got.max() <= 0.5
    for th in (0.3, 0.8):
        np.testing.assert_array_equal(tio.ambiguity_map(got, th), jio.ambiguity_map(want, th))
        np.testing.assert_array_equal(tio.ambiguity_map(got_t, th).numpy(),
                                      np.asarray(jio.ambiguity_map(jnp.asarray(want), th)))


def test_eval_loaders_equal_jax(tmp_path, rng):
    """KITTI's uint16 PNG, an 8-bit golden PNG and the Middlebury PFM (the
    port's writer, from a tensor, read by both packages)."""
    raw = (rng.random((10, 14)) * 60000).astype(np.uint16)
    raw[0, :4] = 0
    kitti = str(tmp_path / "kitti.png")
    Image.fromarray(raw).save(kitti)
    (d, v), (jd, jv) = teval.load_kitti_disparity(kitti), jeval.load_kitti_disparity(kitti)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(d, raw / np.float32(256.0))
    assert not v[0, :4].any() and v.sum() == raw.size - 4

    golden = str(tmp_path / "golden.png")
    Image.fromarray((rng.random((10, 14, 3)) * 255).astype(np.uint8)).save(golden)
    np.testing.assert_array_equal(teval.load_golden_png(golden, 0.25),
                                  jeval.load_golden_png(golden, 0.25))

    disp = (rng.random((9, 11)) * 50).astype(np.float32)
    disp[2, 3] = np.inf
    ours, theirs = str(tmp_path / "t.pfm"), str(tmp_path / "j.pfm")
    teval.save_middlebury_pfm(ours, torch.from_numpy(disp))
    jeval.save_middlebury_pfm(theirs, disp)
    assert _bytes(ours) == _bytes(theirs)
    (d, v), (jd, jv) = teval.load_middlebury_pfm(ours), jeval.load_middlebury_pfm(ours)
    np.testing.assert_array_equal(d, disp)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(v, jv)
    assert not v[2, 3]
    assert os.path.getsize(ours) == len(b"Pf\n11 9\n-1.0\n") + 4 * disp.size
