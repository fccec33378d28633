"""Rectification and reprojection (port of `stereomatch_tpu/geometry/`):
`rectify.py` is a byte copy of the JAX package's numpy module; the remap and
the reprojection run on torch tensors."""

from .rectify import (
    RectifiedGeometry,
    init_undistort_rectify_map,
    rectified_geometry,
    rodrigues,
    stereo_rectify,
    undistort_points,
)
from .remap import remap_bilinear
from .reproject import reproject_image_to_3d, scale_q

__all__ = [
    "RectifiedGeometry",
    "init_undistort_rectify_map",
    "rectified_geometry",
    "rodrigues",
    "stereo_rectify",
    "undistort_points",
    "remap_bilinear",
    "reproject_image_to_3d",
    "scale_q",
]
