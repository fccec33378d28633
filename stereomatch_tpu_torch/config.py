"""The frozen configs of the port: its own copy of what it uses from
`stereomatch_tpu/config.py` (`CensusConfig`, `BMConfig`, `SGBMConfig`,
`CostVolumeConfig`, `ZNCCConfig`, `GuidedFilterConfig`, `DenoiseConfig`,
`MSTConfig`, `production_mst_config`, `PatchMatchConfig`, `CoupledConfig`,
`LRCheckConfig`, `WeightedMedianConfig`, `RectifyConfig`,
`SGBMPipelineConfig`, `CostVolumePipelineConfig`, `replace`).

Field names, defaults and signatures are the JAX package's, so a config
built from the same fields drives either package the same way
(tests/test_torch_config.py holds the copies equal field by field). The
port reads configs by field only and never by class. Fields that mean
nothing in the port say so.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = [
    "BMConfig",
    "CensusConfig",
    "CostVolumeConfig",
    "CostVolumePipelineConfig",
    "CoupledConfig",
    "DenoiseConfig",
    "GuidedFilterConfig",
    "LRCheckConfig",
    "MSTConfig",
    "PatchMatchConfig",
    "RectifyConfig",
    "SGBMConfig",
    "SGBMPipelineConfig",
    "WeightedMedianConfig",
    "ZNCCConfig",
    "production_mst_config",
    "replace",
]


@dataclass(frozen=True)
class CensusConfig:
    """Ternary census stereo (ref: src/StereoMatching.cpp:27-114).

    The reference uses a 9x17 window (win_rw=4 horizontal half-width,
    win_rh=8 vertical half-width), a 3-level census with dead-band
    ``epsilon`` on [0,1]-normalized intensities, Hamming cost and WTA over
    d in [0, d_max].
    """

    win_rw: int = 4
    win_rh: int = 8
    epsilon: float = 0.0045
    d_max: int = 50


@dataclass(frozen=True)
class BMConfig:
    """StereoBM parameter surface, mirroring cv::StereoBM as configured by
    the reference's legacy CLI (src/stereo_opencv (copy).cpp:258-268):
    preFilterCap 31, blockSize 9, minDisparity 0, textureThreshold 10,
    uniquenessRatio 15, speckle 100/32, disp12MaxDiff 1.
    """

    min_disp: int = 0
    num_disp: int = 128
    block_size: int = 9
    prefilter_cap: int = 31
    texture_threshold: int = 10
    uniqueness_ratio: int = 15
    speckle_window_size: int = 100
    speckle_range: int = 32
    disp12_max_diff: int = 1
    # rectification valid-pixel ROIs (x, y, w, h), the bm->setROI1/2 the
    # reference's legacy CLI feeds from stereoRectify. When both are set,
    # validity is restricted to cv::getValidDisparityROI(roi1, roi2, ...)
    # (ops/bm.py::valid_disparity_roi). Tuples keep the dataclass hashable.
    roi1: tuple[int, int, int, int] | None = None
    roi2: tuple[int, int, int, int] | None = None


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
    # read by pipelines.sgbm_pipeline's speckle filter
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
    # local-contrast box radius; not read by the port, as by neither
    # package's cost-volume pipeline
    mean_subtract_radius: int = 17

    @property
    def num_disp(self) -> int:
        return self.max_disp - self.min_disp + 1


@dataclass(frozen=True)
class ZNCCConfig:
    """Windowed ZNCC/AD/AGD gray cost volume
    (ref: buildCostVolumeSharedMemory, src/PatchMatchStereoGPU.cu:1298-1479).
    """

    min_disp: int = 0
    max_disp: int = 127
    win_radius: int = 4
    metric: str = "zncc"  # "zncc" | "ad" | "agd"
    bad_cost: float = 1.0


@dataclass(frozen=True)
class GuidedFilterConfig:
    """Guided-filter cost-volume smoothing (ref production constants
    eps=(0.01*255)^2, win_rad=9, src/PatchMatchStereoGPU.cu:9000-9001)."""

    radius: int = 9
    eps: float = (0.01 * 255.0) ** 2
    slab: int = 16  # disparity slices filtered per pass (memory knob)


@dataclass(frozen=True)
class DenoiseConfig:
    """Weighted-Huber (Newcombe-style) primal-dual disparity denoise
    (ref: variationalDisparityDenoise, src/PatchMatchStereoGPU.cu:7809-7940;
    kernels :1042-1126). Constants from .cu:7860-7880: delta=gamma=0.00159,
    sigma=1/(8*0.02), tau=0.02, per-pixel weight exp(-alpha*|grad I|^beta)
    with alpha=10, beta=1; lambda=0.5 at the call site (.cu:9226-9227).
    """

    lam: float = 0.5
    delta: float = 0.00159
    gamma: float = 0.00159
    sigma: float = 1.0 / (8.0 * 0.02)
    tau: float = 0.02
    alpha: float = 10.0
    beta: float = 1.0
    iterations: int = 100


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


@dataclass(frozen=True)
class PatchMatchConfig:
    """Slanted-plane PatchMatch stereo.

    CPU reference (src/pm.cpp:4-6, pm.h:159-162): WINDOW_SIZE=35,
    MAX_DISPARITY=60, PLANE_PENALTY=120, adaptive weight
    w(p,q)=exp(-||dc||_1/gamma) with gamma=10 (caller), dissimilarity
    (1-alpha)*min(||dc||_1, tau_c) + alpha*min(||dgrad||_1, tau_g).
    GPU reference (src/PatchMatchStereoGPU.cu:861-998, :1740-2010).

    The window cost is evaluated on a subsampled tap grid (``tap_stride``)
    instead of materializing the rows*cols*35*35 weight tensor of
    pm.cpp:447-487, the trick the reference's own huber variant uses
    (window subsampled stride 5, .cu:3126-3128).
    """

    alpha: float = 0.9
    gamma: float = 10.0
    tau_c: float = 10.0
    tau_g: float = 2.0
    window_size: int = 35
    tap_stride: int = 5
    min_disp: float = 0.0
    max_disp: float = 60.0
    plane_penalty: float = 120.0
    iterations: int = 3
    # not read by either package (the refinement ladder stops at 0.1)
    refine_end_dz: float = 0.1
    # "grad_sign": the GPU kernel's active metric (sign-of-gradient census,
    # .cu:981-983); "adgrad": the CPU pm dissimilarity
    # (1-alpha)*min(L1color, tau_c) + alpha*min(L1grad, tau_g) (pm.cpp:97-104)
    metric: str = "grad_sign"
    # Storage dtype of the per-tap feature maps (padded color, gray and
    # gradient images): "bfloat16" halves the bytes plane_cost reads.
    # Features are 0..255, so bf16 quantizes them to about one gray level;
    # every L1, weight and sum runs in float32 after the loads.
    feature_dtype: str = "float32"


@dataclass(frozen=True)
class CoupledConfig:
    """Coupled PatchMatch <-> variational engine (the reference's Family E
    data-step set: evaluateCost_huber src/PatchMatchStereoGPU.cu:3033-3271,
    stereoMatching_huber :3273-3581, huberROFSmooth :3903-4073, and the
    AL-WTA MCCNN_ALTV_CostVolumeWTA :4748-4803 with the alternation loop
    :7331-7727).

    Constants cited: lambda_data=50 (.cu:3299), window stride 5
    (:3126-3128), weight gamma 255/5 on [0,1] colors = 5 on [0,255]
    (:3047), out-of-range tap cost 1.0 / weight 0.7 (:3253-3254), volume
    lerp clamp 0.5 (:3200), Huber eps 0.001 (:3938), primal/dual steps
    1/sqrt(8) (:3940,:4046). The theta coupling schedule ramps linearly
    from theta_start to theta_end.
    """

    max_disp: int = 60
    window_size: int = 35
    tap_stride: int = 5
    gamma_pmsh: float = 5.0
    lambda_data: float = 50.0
    oob_cost: float = 1.0
    oob_weight: float = 0.7
    clamp: float = 0.5
    huber_eps: float = 0.001
    outer_iterations: int = 10
    smooth_iters: int = 10
    theta_d_start: float = 5.0
    theta_d_end: float = 50.0
    theta_n_start: float = 0.5
    theta_n_end: float = 5.0
    # the AL-WTA variant (coupled_wta_stereo): lambda_d weights the volume
    # term; theta_inv grows by 1/(1 - beta*i) per round (.cu:7532)
    lambda_d: float = 1.0
    theta_inv0: float = 1.0
    beta_anneal: float = 0.01


@dataclass(frozen=True)
class LRCheckConfig:
    """Left-right consistency check + occlusion fill
    (ref: leftRightConsistencyCheck, src/Stereo3DMST.cpp:632-710)."""

    max_diff: float = 1.0
    fill: bool = True


@dataclass(frozen=True)
class WeightedMedianConfig:
    """Color-weighted median filter (ref: pm.cpp:396-435 with 35x35 window;
    GPU 21x21 occluded-only variant .cu:2436-2600)."""

    window_size: int = 21
    gamma: float = 10.0  # not read: weighted_median's gamma follows its caller's intensity range
    tap_stride: int = 2
    bisect_iters: int = 10
    occluded_only: bool = True  # not read: the caller passes the mask


@dataclass(frozen=True)
class RectifyConfig:
    """Stereo rectification (ref: cv::stereoRectify call at
    src/stereo_opencv.cpp:121 with CALIB_ZERO_DISPARITY, alpha=-1)."""

    zero_disparity: bool = True
    alpha: float = -1.0


@dataclass(frozen=True)
class SGBMPipelineConfig:
    sgbm: SGBMConfig = SGBMConfig()
    lr: LRCheckConfig = LRCheckConfig()


@dataclass(frozen=True)
class CostVolumePipelineConfig:
    """costVolumeStereoPlusVariationalDenoise pipeline config
    (ref: src/PatchMatchStereoGPU.cu:8776-9410)."""

    volume: CostVolumeConfig = CostVolumeConfig()
    guided: GuidedFilterConfig = GuidedFilterConfig()
    denoise: DenoiseConfig = DenoiseConfig()


def replace(cfg, **kwargs):
    """Convenience: dataclasses.replace re-export."""
    return dataclasses.replace(cfg, **kwargs)
