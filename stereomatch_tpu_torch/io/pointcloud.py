"""Point-cloud export (port of `stereomatch_tpu/io/pointcloud.py`).

Replaces the reference's interactive PCL viewers and savePCDFileASCII
(src/stereo_opencv.cpp:182-220, stereo_Yin.cpp:223-257, and saveXYZ in
`stereo_opencv (copy).cpp:29-45`) with file outputs. Supports the same
z-filtering the viewers applied (|z| < z_max, stereo_opencv.cpp:190).
Points and colors are numpy arrays or tensors on any device; the files are
byte for byte the JAX package's for the same points. Each writer formats
all rows with one `%` per row on Python floats, which print as the JAX
writers' float32 scalars do.
"""

from __future__ import annotations

import numpy as np

from .images import to_numpy

__all__ = ["filter_cloud", "save_ply", "save_pcd", "save_xyz"]


def filter_cloud(xyz, rgb=None, z_max: float | None = None, max_abs: float = 1e4):
    """Flatten an (H, W, 3) reprojection into an (N, 3) numpy cloud,
    dropping non-finite points, |coord| >= max_abs (OpenCV
    missing-disparity big values) and optionally |z| >= z_max."""
    pts = to_numpy(xyz, np.float32).reshape(-1, 3)
    cols = None if rgb is None else to_numpy(rgb).reshape(-1, 3)
    keep = np.isfinite(pts).all(axis=1) & (np.abs(pts) < max_abs).all(axis=1)
    if z_max is not None:
        keep &= np.abs(pts[:, 2]) < z_max
    pts = pts[keep]
    if cols is not None:
        cols = cols[keep]
    return pts, cols


def _rows(fmt: str, columns) -> str:
    """One line of `fmt` per row of the given equal-length columns."""
    return "".join(fmt % row for row in zip(*(c.tolist() for c in columns)))


def save_ply(path: str, points, colors=None) -> None:
    pts = to_numpy(points, np.float32).reshape(-1, 3)
    n = len(pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            f.write(_rows("%.6f %.6f %.6f\n", pts.T))
        else:
            cols = np.clip(to_numpy(colors), 0, 255).astype(np.uint8).reshape(-1, 3)
            f.write(_rows("%.6f %.6f %.6f %d %d %d\n", [*pts.T, *cols.T]))


def save_pcd(path: str, points, colors=None) -> None:
    """ASCII PCD v0.7 (the format pcl::io::savePCDFileASCII writes,
    ref call: src/stereo_opencv.cpp:219)."""
    pts = to_numpy(points, np.float32).reshape(-1, 3)
    n = len(pts)
    with_rgb = colors is not None
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n")
        if with_rgb:
            f.write("FIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n")
        else:
            f.write("FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n")
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {n}\nDATA ascii\n")
        if with_rgb:
            cols = np.clip(to_numpy(colors), 0, 255).astype(np.uint32).reshape(-1, 3)
            packed = (cols[:, 0] << 16) | (cols[:, 1] << 8) | cols[:, 2]
            rgbf = packed.astype(np.uint32).view(np.float32)
            f.write(_rows("%.6f %.6f %.6f %.9e\n", [*pts.T, rgbf]))
        else:
            f.write(_rows("%.6f %.6f %.6f\n", pts.T))


def save_xyz(path: str, points) -> None:
    """Plain whitespace XYZ (ref: saveXYZ, `stereo_opencv (copy).cpp:29-45`)."""
    pts = to_numpy(points, np.float32).reshape(-1, 3)
    with open(path, "w") as f:
        f.write(_rows("%.6f %.6f %.6f\n", pts.T))
