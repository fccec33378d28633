"""Stereo rectification: Bouguet's algorithm + undistort/rectify maps.

Re-implements (without OpenCV) the geometry path the reference uses:
  - cv::stereoRectify with CALIB_ZERO_DISPARITY: alpha=-1 at
    src/stereo_opencv.cpp:121 and alpha=0 (valid-pixels-only zoom) at the
    ACTIVE StereoYin call, src/stereo_Yin.cpp:135 — both modes plus the
    full free-scaling range and the valid-pixel ROI outputs are
    implemented and cv2-5.0-oracle-gated (tests/test_geometry.py)
  - cv::initUndistortRectifyMap (src/stereo_opencv.cpp:124-125)

Map computation is host-side numpy (it runs once per calibration); the
per-frame bilinear remap lives in `stereomatch_tpu.geometry.remap` as a JAX
op. The distortion model supports the full OpenCV rational + thin-prism
coefficient vector (k1,k2,p1,p2,k3,k4,k5,k6,s1..s4) — the bundled FLIR
calibration uses the rational model (k4 != 0).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "rodrigues",
    "undistort_points",
    "distort_normalized",
    "stereo_rectify",
    "init_undistort_rectify_map",
    "RectifiedGeometry",
    "rectified_geometry",
]


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Rodrigues conversion, both directions (vector<->matrix)."""
    r = np.asarray(r, dtype=np.float64)
    if r.shape in [(3,), (3, 1), (1, 3)]:
        r = r.reshape(3)
        theta = np.linalg.norm(r)
        if theta < 1e-30:
            return np.eye(3)
        k = r / theta
        K = np.array(
            [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=np.float64
        )
        return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
    # matrix -> vector
    R = r.reshape(3, 3)
    A = (R - R.T) * 0.5
    rho = np.array([A[2, 1], A[0, 2], A[1, 0]])
    s = np.linalg.norm(rho)
    c = (np.trace(R) - 1) * 0.5
    c = np.clip(c, -1.0, 1.0)
    if s < 1e-12 and c > 0:
        return np.zeros(3)
    if s < 1e-12 and c < 0:
        # theta = pi
        V = R + np.eye(3)
        v = V[:, np.argmax(np.diag(V))]
        u = v / np.linalg.norm(v)
        return np.pi * u * (1 if (u[0] > 0 or (u[0] == 0 and u[1] > 0) or (u[0] == 0 and u[1] == 0 and u[2] > 0)) else -1)
    theta = np.arctan2(s, c)
    return rho / s * theta


def _dist14(D) -> np.ndarray:
    """Pad an OpenCV distortion vector to 14 coefficients
    (k1,k2,p1,p2,k3,k4,k5,k6,s1,s2,s3,s4,taux,tauy)."""
    d = np.zeros(14)
    if D is None:
        return d
    Df = np.asarray(D, dtype=np.float64).reshape(-1)
    d[: Df.size] = Df
    if abs(d[12]) > 0 or abs(d[13]) > 0:
        raise NotImplementedError("tilted sensor model not supported")
    return d


def distort_normalized(x: np.ndarray, y: np.ndarray, D) -> tuple[np.ndarray, np.ndarray]:
    """Apply the OpenCV distortion model to normalized image coordinates."""
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, *_ = _dist14(D)
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
    xy2 = 2 * x * y
    xd = x * radial + p1 * xy2 + p2 * (r2 + 2 * x * x) + s1 * r2 + s2 * r4
    yd = y * radial + p1 * (r2 + 2 * y * y) + p2 * xy2 + s3 * r2 + s4 * r4
    return xd, yd


def undistort_points(
    pts: np.ndarray,
    M: np.ndarray,
    D,
    R: np.ndarray | None = None,
    P: np.ndarray | None = None,
    iterations: int = 5,
) -> np.ndarray:
    """cv::undistortPoints equivalent: pixel coords -> normalized undistorted
    coords (or re-projected through R/P when given).

    Uses OpenCV's exact fixed-point iteration (5 rounds of
    x = (x0 - deltaX) * icdist) rather than a fully-converged Newton solve,
    so results match cv2 bit-for-bit in behavior — stereo_rectify's new
    principal points depend on this."""
    pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
    fx, fy = M[0, 0], M[1, 1]
    cx, cy = M[0, 2], M[1, 2]
    x0 = (pts[:, 0] - cx) / fx
    y0 = (pts[:, 1] - cy) / fy
    x, y = x0.copy(), y0.copy()
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, *_ = _dist14(D)
    for _ in range(iterations):
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        icdist = (1 + k4 * r2 + k5 * r4 + k6 * r6) / (1 + k1 * r2 + k2 * r4 + k3 * r6)
        delta_x = 2 * p1 * x * y + p2 * (r2 + 2 * x * x) + s1 * r2 + s2 * r4
        delta_y = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y + s3 * r2 + s4 * r4
        x = (x0 - delta_x) * icdist
        y = (y0 - delta_y) * icdist
    out = np.stack([x, y], axis=-1)
    if R is not None or P is not None:
        Rm = np.eye(3) if R is None else np.asarray(R, dtype=np.float64)
        if P is not None:
            Pm = np.asarray(P, dtype=np.float64)
            Rm = Pm[:3, :3] @ Rm
        h = np.concatenate([out, np.ones((len(out), 1))], axis=1) @ Rm.T
        out = h[:, :2] / h[:, 2:3]
    return out


@dataclass
class RectifyResult:
    R1: np.ndarray
    R2: np.ndarray
    P1: np.ndarray
    P2: np.ndarray
    Q: np.ndarray
    # valid-pixel ROIs (x, y, width, height) in the rectified image — the
    # rectangles cv::stereoRectify hands the legacy CLI's BM config
    # (src/stereo_opencv (copy).cpp:258-268)
    roi1: tuple[int, int, int, int] = (0, 0, 0, 0)
    roi2: tuple[int, int, int, int] = (0, 0, 0, 0)


def _rectify_rectangles(M, D, R, P, image_size, n: int = 9):
    """Inner (all-valid, inscribed) and outer (bounding) rectangles of
    the source image mapped through undistortion + rectification —
    OpenCV's getRectangles: an n x n grid over [0, W-1] x [0, H-1]
    (cv2 5.0 samples pixel centers of the edge pixels; older releases
    used [0, W] x [0, H] — the [0, W-1] grid matches the cv2 5.0 oracle
    to ~1e-8 in the resulting scales, the [0, W] one only to ~1e-3),
    pushed through undistortPoints(..., R, P). Returns (inner, outer)
    as (x0, y0, w, h) float rects in rectified-pixel coordinates."""
    nx, ny = image_size
    xs = np.arange(n) * ((nx - 1) / (n - 1))
    ys = np.arange(n) * ((ny - 1) / (n - 1))
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    und = undistort_points(pts, M, D, R=R, P=P).reshape(n, n, 2)
    ox0, oy0 = und[..., 0].min(), und[..., 1].min()
    ox1, oy1 = und[..., 0].max(), und[..., 1].max()
    ix0 = und[:, 0, 0].max()  # left edge pushed right-most
    ix1 = und[:, n - 1, 0].min()
    iy0 = und[0, :, 1].max()
    iy1 = und[n - 1, :, 1].min()
    inner = (ix0, iy0, ix1 - ix0, iy1 - iy0)
    outer = (ox0, oy0, ox1 - ox0, oy1 - oy0)
    return inner, outer


def stereo_rectify(
    M1: np.ndarray,
    D1,
    M2: np.ndarray,
    D2,
    image_size: tuple[int, int],
    R: np.ndarray,
    T: np.ndarray,
    zero_disparity: bool = True,
    alpha: float = -1.0,
) -> RectifyResult:
    """Bouguet stereo rectification (cv::stereoRectify semantics).

    image_size is (width, height). With alpha < 0
    (src/stereo_opencv.cpp:121) no free-scaling of the new camera matrix
    is performed. With 0 <= alpha <= 1 the common focal length is scaled
    by s0*(1-alpha) + s1*alpha, where s0 zooms until only valid pixels
    remain visible (alpha=0 — the ACTIVE StereoYin call,
    src/stereo_Yin.cpp:135 passes CALIB_ZERO_DISPARITY, 0) and s1 zooms
    out until every source pixel is visible (alpha=1). Valid-pixel ROIs
    are returned in every mode, as cv2 5.0 does (oracle-gated in
    tests/test_geometry.py).
    """
    nx, ny = image_size
    M1 = np.asarray(M1, dtype=np.float64)
    M2 = np.asarray(M2, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64).reshape(3, 3)
    T = np.asarray(T, dtype=np.float64).reshape(3)

    # split the relative rotation evenly between the two cameras
    om = rodrigues(R) * -0.5
    r_r = rodrigues(om)
    t = r_r @ T

    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c = t[idx]
    nt = np.linalg.norm(t)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0

    # rotation that aligns the baseline with the chosen image axis
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0:
        ww *= np.arccos(np.clip(abs(c) / nt, -1.0, 1.0)) / nw
    wR = rodrigues(ww)

    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T

    # common focal length: mean of both cameras' focal along the non-baseline
    # axis (OpenCV >= 5 behavior; pre-5 used the min with a barrel-distortion
    # shrink)
    fc_new = 0.5 * (M1[idx ^ 1, idx ^ 1] + M2[idx ^ 1, idx ^ 1])

    # new principal points: center the undistorted, rotated image corners
    cc_new = np.zeros((2, 2))
    for k, (A, Dk, Rk) in enumerate([(M1, D1, R1), (M2, D2, R2)]):
        corners = np.array(
            [[(i % 2) * (nx - 1), (i // 2) * (ny - 1)] for i in range(4)],
            dtype=np.float64,
        )
        und = undistort_points(corners, A, Dk)
        h = np.concatenate([und, np.ones((4, 1))], axis=1) @ Rk.T
        proj = fc_new * h[:, :2] / h[:, 2:3]
        avg = proj.mean(axis=0)
        cc_new[k, 0] = (nx - 1) / 2 - avg[0]
        cc_new[k, 1] = (ny - 1) / 2 - avg[1]

    if zero_disparity:
        cc_new[0] = cc_new[1] = cc_new.mean(axis=0)
    elif idx == 0:
        cc_new[0, 1] = cc_new[1, 1] = cc_new[:, 1].mean()
    else:
        cc_new[0, 0] = cc_new[1, 0] = cc_new[:, 0].mean()

    # ---- free-scaling (alpha) + valid-pixel ROIs (cv2 5.0 semantics:
    # ROIs come back in EVERY mode; alpha<0 means scale s=1). The inner/
    # outer rectangles are measured through the UNSCALED P matrices; only
    # the common focal is scaled (with new_size == image_size the
    # principal points are unchanged). ----
    P1u = np.zeros((3, 4))
    P1u[0, 0] = P1u[1, 1] = fc_new
    P1u[2, 2] = 1.0
    P1u[0, 2], P1u[1, 2] = cc_new[0]
    P2u = P1u.copy()
    P2u[0, 2], P2u[1, 2] = cc_new[1]

    inner1, outer1 = _rectify_rectangles(M1, D1, R1, P1u, image_size)
    inner2, outer2 = _rectify_rectangles(M2, D2, R2, P2u, image_size)

    cx1_0, cy1_0 = cc_new[0]
    cx2_0, cy2_0 = cc_new[1]
    # new image size == calibration image size here (the reference passes
    # img_size straight through, src/stereo_Yin.cpp:135), so the centered
    # principal points are the unscaled ones
    cx1, cy1, cx2, cy2 = cx1_0, cy1_0, cx2_0, cy2_0
    s = 1.0
    if alpha >= 0:
        alpha = min(alpha, 1.0)

        def _s_view(cx, cy, cx0, cy0, rect, reduce_fn):
            x0, y0, rw, rh = rect
            return reduce_fn(
                [cx / (cx0 - x0), cy / (cy0 - y0),
                 (nx - 1 - cx) / (x0 + rw - cx0),
                 (ny - 1 - cy) / (y0 + rh - cy0)]
            )

        s0 = max(_s_view(cx1, cy1, cx1_0, cy1_0, inner1, max),
                 _s_view(cx2, cy2, cx2_0, cy2_0, inner2, max))
        s1 = min(_s_view(cx1, cy1, cx1_0, cy1_0, outer1, min),
                 _s_view(cx2, cy2, cx2_0, cy2_0, outer2, min))
        s = s0 * (1 - alpha) + s1 * alpha
        fc_new *= s

    P1 = P1u.copy()
    P1[0, 0] = P1[1, 1] = fc_new
    P1[0, 2], P1[1, 2] = cx1, cy1
    P2 = P1.copy()
    P2[0, 2], P2[1, 2] = cx2, cy2
    P2[idx, 3] = t[idx] * fc_new  # baseline * focal

    def _roi(rect, cx0, cy0, cx, cy):
        x0, y0, rw, rh = rect
        rx = int(np.ceil((x0 - cx0) * s + cx))
        ry = int(np.ceil((y0 - cy0) * s + cy))
        rx1 = rx + int(np.floor(rw * s))
        ry1 = ry + int(np.floor(rh * s))
        # intersect with the image rectangle
        ix, iy = max(rx, 0), max(ry, 0)
        return (ix, iy, max(min(rx1, nx) - ix, 0), max(min(ry1, ny) - iy, 0))

    roi1 = _roi(inner1, cx1_0, cy1_0, cx1, cy1)
    roi2 = _roi(inner2, cx2_0, cy2_0, cx2, cy2)

    Q = np.zeros((4, 4))
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3] = -cc_new[0, 0]
    Q[1, 3] = -cc_new[0, 1]
    Q[2, 3] = fc_new
    Q[3, 2] = -1.0 / t[idx]
    Q[3, 3] = (cc_new[0, idx] - cc_new[1, idx]) / t[idx]

    return RectifyResult(R1=R1, R2=R2, P1=P1, P2=P2, Q=Q,
                         roi1=roi1, roi2=roi2)


def init_undistort_rectify_map(
    M: np.ndarray,
    D,
    R: np.ndarray | None,
    P: np.ndarray,
    image_size: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray]:
    """cv::initUndistortRectifyMap equivalent. image_size is (width, height).
    Returns float32 (H, W) mapx, mapy in source-pixel coordinates."""
    nx, ny = image_size
    M = np.asarray(M, dtype=np.float64)
    Rm = np.eye(3) if R is None else np.asarray(R, dtype=np.float64).reshape(3, 3)
    Pm = np.asarray(P, dtype=np.float64)
    A = Pm[:3, :3] @ Rm
    iR = np.linalg.inv(A)

    u, v = np.meshgrid(np.arange(nx, dtype=np.float64), np.arange(ny, dtype=np.float64))
    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    W = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    x = X / W
    y = Y / W
    xd, yd = distort_normalized(x, y, D)
    mapx = M[0, 0] * xd + M[0, 2]
    mapy = M[1, 1] * yd + M[1, 2]
    return mapx.astype(np.float32), mapy.astype(np.float32)


@dataclass
class RectifiedGeometry:
    """Precomputed rectification maps + matrices for a stereo rig."""

    R1: np.ndarray
    R2: np.ndarray
    P1: np.ndarray
    P2: np.ndarray
    Q: np.ndarray
    map1x: np.ndarray
    map1y: np.ndarray
    map2x: np.ndarray
    map2y: np.ndarray
    roi1: tuple[int, int, int, int] = (0, 0, 0, 0)
    roi2: tuple[int, int, int, int] = (0, 0, 0, 0)


def rectified_geometry(cal, image_size: tuple[int, int],
                       alpha: float = -1.0) -> RectifiedGeometry:
    """Full rectification setup from a StereoCalibration, mirroring the
    stereoRectify + initUndistortRectifyMap x2 sequence at
    src/stereo_opencv.cpp:121-125 (alpha=-1 there; the StereoYin binary
    passes alpha=0, src/stereo_Yin.cpp:135). image_size is
    (width, height)."""
    rect = stereo_rectify(cal.M1, cal.D1, cal.M2, cal.D2, image_size,
                          cal.R, cal.T, alpha=alpha)
    m1x, m1y = init_undistort_rectify_map(cal.M1, cal.D1, rect.R1, rect.P1, image_size)
    m2x, m2y = init_undistort_rectify_map(cal.M2, cal.D2, rect.R2, rect.P2, image_size)
    return RectifiedGeometry(
        R1=rect.R1,
        R2=rect.R2,
        P1=rect.P1,
        P2=rect.P2,
        Q=rect.Q,
        map1x=m1x,
        map1y=m1y,
        map2x=m2x,
        map2y=m2y,
        roi1=rect.roi1,
        roi2=rect.roi2,
    )
