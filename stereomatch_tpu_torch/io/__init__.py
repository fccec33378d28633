"""Host file I/O of the port (port of `stereomatch_tpu/io/`): calibrations
(`calibration.py`, a byte copy of the JAX package's), images, mc-cnn cost
volumes and point clouds; every saver takes numpy arrays or tensors."""

from .calibration import StereoCalibration, load_filestorage, load_stereo_calibration
from .costvolume import (
    ambiguity_map,
    clean_mccnn,
    load_mccnn_volume,
    save_mccnn_volume,
)
from .images import (
    load_image,
    normalize01,
    save_disparity_png,
    save_image,
    to_gray,
    to_planar,
)
from .pointcloud import filter_cloud, save_pcd, save_ply, save_xyz

__all__ = [
    "StereoCalibration",
    "load_filestorage",
    "load_stereo_calibration",
    "load_mccnn_volume",
    "save_mccnn_volume",
    "clean_mccnn",
    "ambiguity_map",
    "load_image",
    "save_image",
    "save_disparity_png",
    "to_gray",
    "to_planar",
    "normalize01",
    "filter_cloud",
    "save_ply",
    "save_pcd",
    "save_xyz",
]
