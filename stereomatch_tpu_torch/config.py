"""The frozen configs of the port: its own copy of what it uses from
`stereomatch_tpu/config.py` (`SGBMConfig`, `CostVolumeConfig`,
`GuidedFilterConfig`, `MSTConfig`, `production_mst_config`).

Field names, defaults and signatures are the JAX package's, so a config
built from the same fields drives either package the same way
(tests/test_torch_config.py holds the copies equal field by field). The
port reads configs by field only and never by class. Fields that mean
nothing in the port say so.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "CostVolumeConfig",
    "GuidedFilterConfig",
    "MSTConfig",
    "SGBMConfig",
    "production_mst_config",
]


@dataclass(frozen=True)
class SGBMConfig:
    """SGBM parameter surface, mirroring OpenCV StereoSGBM as configured by
    the reference (src/StereoMatching.cpp:148-193): blockSize 5,
    P1=8*cn*bs^2, P2=32*cn*bs^2, minDisparity 16, numDisparities 16*k,
    uniquenessRatio 10, speckle 100/32, disp12MaxDiff 1, MODE_HH (full
    8-path).
    """

    min_disp: int = 16
    num_disp: int = 256
    block_size: int = 5
    channels: int = 1
    p1: int | None = None  # default 8 * channels * block_size**2
    p2: int | None = None  # default 32 * channels * block_size**2
    prefilter_cap: int = 63
    uniqueness_ratio: int = 10
    # not read by the port (no speckle filter on the ported path)
    speckle_window_size: int = 100
    speckle_range: int = 32
    disp12_max_diff: int = 1
    # 8 = MODE_HH (full 8-path); 5 = MODE_SGBM's single-pass set
    # {N, NW, NE, E, W}; 4 = plain N/S/E/W
    num_paths: int = 8
    # "float32" matches OpenCV's int16 arithmetic exactly (integer-valued
    # costs); "bfloat16" halves the cost volume's bytes at the price of
    # tie-level rounding in weak-texture pixels
    cost_dtype: str = "float32"

    def resolved_p1p2(self) -> tuple[int, int]:
        bs2 = self.block_size * self.block_size
        p1 = self.p1 if self.p1 is not None else 8 * self.channels * bs2
        p2 = self.p2 if self.p2 is not None else 32 * self.channels * bs2
        return p1, p2


@dataclass(frozen=True)
class CostVolumeConfig:
    """Pixelwise truncated AD + gradient BGR cost volume
    (ref: buildCostVolumeSharedMemoryBGR, src/PatchMatchStereoGPU.cu:1482-1550):
    cost = 0.11*min(L1color/3, 7) + 0.89*min(|d forward-gradient|, 2),
    out-of-range pixels get bad_cost. Images are local-contrast (box-mean
    subtracted) beforehand in the production pipeline
    (src/PatchMatchStereoGPU.cu:8947-8961).
    """

    min_disp: int = 0
    max_disp: int = 127
    color_truncation: float = 7.0
    gradient_truncation: float = 2.0
    bad_cost: float = 3.0
    color_weight: float = 0.11
    gradient_weight: float = 0.89
    mean_subtract_radius: int = 17  # local-contrast box radius; not read by the port

    @property
    def num_disp(self) -> int:
        return self.max_disp - self.min_disp + 1


@dataclass(frozen=True)
class GuidedFilterConfig:
    """Guided-filter cost-volume smoothing (ref production constants
    eps=(0.01*255)^2, win_rad=9, src/PatchMatchStereoGPU.cu:9000-9001)."""

    radius: int = 9
    eps: float = (0.01 * 255.0) ** 2
    slab: int = 16  # disparity slices filtered per pass (memory knob)


@dataclass(frozen=True)
class MSTConfig:
    """Stereo3DMST: segment-tree (MST forest) cost aggregation with 3D plane
    labels (ref: src/Stereo3DMST.cpp). Constants from Stereo3DMST.cpp:830-832:
    gamma=1/12, c=5000, min_cc_size=200; Dmax=100 and 100 iterations from the
    stereo_Yin.cpp:207 call site.
    """

    gamma: float = 1.0 / 12.0
    c: float = 5000.0
    min_cc_size: int = 200
    max_disp: int = 100
    iterations: int = 100
    median_prefilter: int = 3
    # Trees are split into segments whose gamma-weighted depth range is at
    # most this bound, so the exp-factorized Euler-tour aggregation stays
    # well-conditioned in fp32; `carry_iters` rounds of carry injection
    # restore the aggregation across segment cuts.
    max_log_range: float = 4.0
    carry_iters: int = 2
    # "NONE" is the only prior ported (the others raise, ROADMAP.md), so
    # smoothness_iters is not read
    smoothness_prior: str = "NONE"
    smoothness_iters: int = 50
    # divide the tree-filtered cost by the tree-filtered ONES volume
    # (src/PatchMatchStereoGPU.cu:5415-5429); label selection is invariant
    normalize_aggregation: bool = False
    # cost-volume storage dtype for label_cost reads; every aggregation
    # pass stays float32
    volume_dtype: str = "float32"
    # forest construction: "host" (native/treebuild.cpp, on the CPU) or
    # "device" (ops/device_forest.py)
    forest_backend: str = "host"
    # Not read by the port: its segmented scans always run K2
    # (csrc/seg_scan.cu) on CUDA and K2's twin on the CPU. Kept so the
    # JAX package's config fields map one to one.
    scan_backend: str = "xla"


def production_mst_config(max_disp: int, on_tpu: bool = True, **overrides) -> MSTConfig:
    """The measured production recipe for 3DMST refinement in the
    SGBM-seeded composition (models/sgbm_mst.py), the JAX package's
    `production_mst_config` field for field: bfloat16 volume, one carry
    round (paths crossing two segment cuts weigh at most e^{-2*4} ~ 3e-4),
    and `scan_backend` "pallas" if `on_tpu` else "xla". The port reads
    neither `on_tpu` nor `scan_backend`; they stay so the two packages'
    configs compare equal."""
    kw = dict(
        max_disp=max_disp,
        volume_dtype="bfloat16",
        carry_iters=1,
        scan_backend="pallas" if on_tpu else "xla",
    )
    kw.update(overrides)
    return MSTConfig(**kw)
