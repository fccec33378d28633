"""OpenCV FileStorage calibration parser (XML and YAML 1.0 dialects).

The reference loads stereo calibration from two file formats:
  - `FLIR_stereo_para.xml`  (OpenCV XML FileStorage), loaded at
    src/stereo_opencv.cpp:96-119
  - `cam_stereo_pheno.yml`  (OpenCV %YAML:1.0 FileStorage), loaded at
    src/stereo_Yin.cpp:55-87

Both store named `opencv-matrix` nodes (rows/cols/dt/data). This module
parses both without depending on OpenCV, returning numpy arrays, and wraps
the standard stereo entries (M1, D1, M2, D2, R, T, optional precomputed
R1, R2, P1, P2, Q) in a typed :class:`StereoCalibration`.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

__all__ = ["StereoCalibration", "load_filestorage", "load_stereo_calibration"]


def _parse_xml(text: str) -> dict[str, np.ndarray]:
    root = ET.fromstring(text)
    out: dict[str, np.ndarray] = {}
    for node in root:
        if node.get("type_id") == "opencv-matrix":
            rows = int(node.findtext("rows"))
            cols = int(node.findtext("cols"))
            data = np.fromstring(node.findtext("data"), sep=" ")  # noqa: NPY201
            out[node.tag] = data.reshape(rows, cols)
        else:
            txt = (node.text or "").strip()
            if txt:
                try:
                    out[node.tag] = np.array(float(txt))
                except ValueError:
                    out[node.tag] = txt  # type: ignore[assignment]
    return out


_YAML_MAT_RE = re.compile(
    r"^(\w+):\s*!!opencv-matrix\s*$"
    r"(.*?)"
    r"(?=^\w+:|\Z)",
    re.M | re.S,
)
_YAML_SCALAR_RE = re.compile(r"^(\w+):\s*([^\s!].*?)\s*$", re.M)


def _parse_yaml(text: str) -> dict[str, np.ndarray]:
    # OpenCV writes "%YAML:1.0" which standard YAML parsers reject; we parse
    # the restricted FileStorage subset directly.
    body = re.sub(r"^%YAML:.*$|^---\s*$", "", text, flags=re.M)
    out: dict[str, np.ndarray] = {}
    for m in _YAML_MAT_RE.finditer(body):
        name, block = m.group(1), m.group(2)
        rows = int(re.search(r"rows:\s*(\d+)", block).group(1))
        cols = int(re.search(r"cols:\s*(\d+)", block).group(1))
        data_m = re.search(r"data:\s*\[(.*?)\]", block, re.S)
        data = np.fromstring(data_m.group(1).replace("\n", " "), sep=",")  # noqa: NPY201
        out[name] = data.reshape(rows, cols)
    # top-level scalars (skip matrix names already captured)
    for m in _YAML_SCALAR_RE.finditer(body):
        name, val = m.group(1), m.group(2)
        if name in out or val.startswith("!!"):
            continue
        try:
            out[name] = np.array(float(val))
        except ValueError:
            out[name] = val  # type: ignore[assignment]
    return out


def load_filestorage(path: str) -> dict[str, np.ndarray]:
    """Parse an OpenCV FileStorage file (.xml or .yml/.yaml) into a dict of
    numpy arrays keyed by node name."""
    with open(path) as f:
        text = f.read()
    if text.lstrip().startswith("<?xml") or path.endswith(".xml"):
        return _parse_xml(text)
    return _parse_yaml(text)


@dataclass
class StereoCalibration:
    """Stereo calibration: intrinsics M1/M2 (3x3), distortion D1/D2
    (OpenCV coefficient vectors, up to 14), inter-camera rotation R (3x3)
    and translation T (3,), plus optional precomputed rectification
    R1, R2 (3x3), P1, P2 (3x4) and disparity-to-depth Q (4x4)."""

    M1: np.ndarray
    D1: np.ndarray
    M2: np.ndarray
    D2: np.ndarray
    R: np.ndarray
    T: np.ndarray
    R1: np.ndarray | None = None
    R2: np.ndarray | None = None
    P1: np.ndarray | None = None
    P2: np.ndarray | None = None
    Q: np.ndarray | None = None
    extras: dict = field(default_factory=dict)

    @classmethod
    def from_file(cls, path: str) -> "StereoCalibration":
        d = load_filestorage(path)
        need = ["M1", "D1", "M2", "D2", "R", "T"]
        missing = [k for k in need if k not in d]
        if missing:
            raise ValueError(f"calibration file {path} missing nodes: {missing}")
        kw = {k: np.asarray(d[k], dtype=np.float64) for k in need}
        kw["T"] = kw["T"].reshape(3)
        for k in ["R1", "R2", "P1", "P2", "Q"]:
            if k in d:
                kw[k] = np.asarray(d[k], dtype=np.float64)
        extras = {k: v for k, v in d.items() if k not in kw}
        return cls(**kw, extras=extras)

    def rescaled(self, scale: float) -> "StereoCalibration":
        """Calibration for images resized by `scale`: intrinsics scale
        (fx, fy, cx, cy), distortion/extrinsics unchanged. Stored
        R1/R2/P1/P2/Q are dropped (recompute via rectified_geometry)."""
        import dataclasses

        s = np.diag([scale, scale, 1.0])
        return dataclasses.replace(
            self,
            M1=s @ self.M1,
            M2=s @ self.M2,
            R1=None,
            R2=None,
            P1=None,
            P2=None,
            Q=None,
        )

    def scaled_q(self, scale: float) -> np.ndarray:
        """Scale the Q matrix for resized images: multiply rows 0..2 of the
        last column by `scale` (ref: StereoMatching::scaleStereoPairQMatrix,
        src/StereoMatching.cpp:195-209)."""
        if self.Q is None:
            raise ValueError("no Q matrix in calibration")
        q = self.Q.copy()
        q[:3, 3] *= scale
        return q


def load_stereo_calibration(path: str) -> StereoCalibration:
    return StereoCalibration.from_file(path)
