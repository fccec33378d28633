"""The port's geometry (stereomatch_tpu_torch/geometry/) against the JAX
package's on the same numpy inputs made from a seed, and against cv2 where
cv2 is the oracle. `rectify.py` is a byte copy of the JAX module, held so.

Measured on the CPU (20 seeded cases of the remap test): the remap's
blend differs from the jitted JAX remap by at most 4.6e-5 on [0, 255]
values, 82% of pixels bit for bit (XLA contracts the four products into
FMAs), held to 1e-4; on maps of whole pixels both return the source bit
for bit. The reprojection runs in both packages as eager float32 ops in the
same order and was bit-equal in 10 cases: held to rtol 1e-6.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import distorted_calibration, identity_calibration
from stereomatch_tpu import geometry as jgeom
from stereomatch_tpu.io import StereoCalibration as JStereoCalibration
from stereomatch_tpu_torch import geometry as tgeom
from stereomatch_tpu_torch.io import StereoCalibration

REMAP_ATOL = 1e-4


def _cal(mats, cls=StereoCalibration):
    return cls(**{k: (v.reshape(3) if k == "T" else v) for k, v in mats.items()})


def test_rectify_is_a_byte_copy():
    from stereomatch_tpu.geometry import rectify as jrect
    from stereomatch_tpu_torch.geometry import rectify as trect

    assert pathlib.Path(trect.__file__).read_bytes() == pathlib.Path(jrect.__file__).read_bytes()


def test_geometry_exports_equal_jax():
    assert tgeom.__all__ == jgeom.__all__


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("border", [0.0, 37.5])
def test_remap_bilinear_vs_jax(rng, channels, border):
    """Maps that reach 5 px outside the image on every side, so taps fall
    outside and on the border; (H, W) and (H, W, 3)."""
    shape = (40, 56) + ((channels,) if channels else ())
    img = (rng.random(shape) * 255).astype(np.float32)
    mapx = rng.uniform(-5, 61, size=(30, 44)).astype(np.float32)
    mapy = rng.uniform(-5, 45, size=(30, 44)).astype(np.float32)
    want = np.asarray(jgeom.remap_bilinear(img, mapx, mapy, border_value=border))
    got = tgeom.remap_bilinear(torch.from_numpy(img), torch.from_numpy(mapx),
                               torch.from_numpy(mapy), border_value=border)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REMAP_ATOL)
    outside = (mapx < -1) | (mapx > 56) | (mapy < -1) | (mapy > 40)
    assert outside.any()
    np.testing.assert_allclose(got.numpy()[outside], border, rtol=0, atol=REMAP_ATOL)


def test_remap_on_whole_pixel_maps_is_exact(rng):
    """The identity calibration's maps: every tap weight is 0 or 1, so both
    packages return the source image bit for bit."""
    h, w = 48, 64
    img = (rng.random((h, w, 3)) * 255).astype(np.float32)
    geo = tgeom.rectified_geometry(_cal(identity_calibration(h, w)), (w, h))
    got = tgeom.remap_bilinear(torch.from_numpy(img), torch.from_numpy(geo.map1x),
                               torch.from_numpy(geo.map1y)).numpy()
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(
        got, np.asarray(jgeom.remap_bilinear(img, geo.map1x, geo.map1y)))


@pytest.mark.parametrize("handle_missing", [False, True])
def test_reproject_vs_jax(rng, handle_missing):
    h, w = 24, 32
    geo = tgeom.rectified_geometry(_cal(distorted_calibration(h, w)), (w, h))
    disp = rng.uniform(-4, 30, size=(h, w)).astype(np.float32)
    disp[3, :5] = 0.0
    want = np.asarray(jgeom.reproject_image_to_3d(jnp.asarray(disp), geo.Q, handle_missing))
    got = tgeom.reproject_image_to_3d(torch.from_numpy(disp), geo.Q, handle_missing)
    assert got.dtype == torch.float32 and got.shape == (h, w, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    if handle_missing:
        assert (got.numpy()[disp <= 0] == np.float32([0.0, 0.0, 10000.0])).all()


def test_scale_q_equals_jax():
    q = tgeom.rectified_geometry(_cal(distorted_calibration(30, 40)), (40, 30)).Q
    for s in (0.5, 0.125, 2.0):
        np.testing.assert_array_equal(tgeom.scale_q(q, s), jgeom.scale_q(q, s))


@pytest.mark.parametrize("alpha", [-1.0, 0.0])
def test_rectified_geometry_equals_jax_and_cv2(alpha):
    """The copy gives the JAX module's maps; both match cv2.stereoRectify
    and cv2.initUndistortRectifyMap on a distorted, rotated rig."""
    cv2 = pytest.importorskip("cv2")
    h, w = 60, 80
    mats = distorted_calibration(h, w)
    ours = tgeom.rectified_geometry(_cal(mats), (w, h), alpha=alpha)
    jax_geo = jgeom.rectified_geometry(_cal(mats, JStereoCalibration), (w, h), alpha=alpha)
    for name in ("R1", "R2", "P1", "P2", "Q", "map1x", "map1y", "map2x", "map2y"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(jax_geo, name))
    R1, R2, P1, P2, Q, roi1, roi2 = cv2.stereoRectify(
        mats["M1"], mats["D1"], mats["M2"], mats["D2"], (w, h), mats["R"], mats["T"],
        flags=cv2.CALIB_ZERO_DISPARITY, alpha=alpha)
    np.testing.assert_allclose(ours.R1, R1, atol=1e-9)
    np.testing.assert_allclose(ours.R2, R2, atol=1e-9)
    np.testing.assert_allclose(ours.P1, P1, atol=1e-3)
    np.testing.assert_allclose(ours.Q, Q, atol=1e-3)
    cmx, cmy = cv2.initUndistortRectifyMap(mats["M1"], mats["D1"], R1, P1, (w, h), cv2.CV_32FC1)
    np.testing.assert_allclose(ours.map1x, cmx, atol=1e-2)
    np.testing.assert_allclose(ours.map1y, cmy, atol=1e-2)


def test_remap_and_reproject_vs_cv2(rng):
    cv2 = pytest.importorskip("cv2")
    img = (rng.random((64, 96, 3)) * 255).astype(np.float32)
    mapx = rng.uniform(-5, 100, size=(50, 70)).astype(np.float32)
    mapy = rng.uniform(-5, 70, size=(50, 70)).astype(np.float32)
    ours = tgeom.remap_bilinear(torch.from_numpy(img), torch.from_numpy(mapx),
                                torch.from_numpy(mapy)).numpy()
    np.testing.assert_allclose(ours, cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR), atol=2e-2)
    q = tgeom.rectified_geometry(_cal(distorted_calibration(24, 32)), (32, 24)).Q
    disp = rng.uniform(1, 60, size=(24, 32)).astype(np.float32)
    np.testing.assert_allclose(tgeom.reproject_image_to_3d(torch.from_numpy(disp), q).numpy(),
                               cv2.reprojectImageTo3D(disp, q), rtol=1e-4, atol=1e-5)
