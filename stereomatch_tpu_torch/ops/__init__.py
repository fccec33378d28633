"""Tensor ops of the port: filters, matching costs (census, AD+gradient,
windowed), disparity selection, post-processing (LR checks, fill), the
variational denoise, speckle filtering, SGBM (whole-frame and banded) and
BM, the TGV and NL2TGV smoothness priors (`tgv`, `nltgv`), forest
construction and the 3DMST tree filter, PatchMatch and its coupled variant
(`patchmatch`, `coupled`), plus the wrappers of the hand-written CUDA
kernels (`sgbm_cuda`, `mst_scan_cuda`)."""

from .filters import (  # noqa: F401
    box_filter,
    box_filter_sum,
    guided_filter_color,
    guided_filter_gray,
    guided_filter_volume,
    median3x3,
)
from .cost import (  # noqa: F401
    adgrad_bgr_volumes,
    bgr_to_gray,
    census_cost_volumes,
    census_stereo,
    local_contrast,
    shifted_stack,
    ternary_census_planes,
    windowed_volumes,
)
from .select import wta_argmin, wta_coupled, wta_disparity  # noqa: F401
from .postprocess import (  # noqa: F401
    lr_check_fill_pair,
    lr_consistency,
    lr_occlusion_mask,
    nearest_valid_fill,
    weighted_median,
)
from .variational import (  # noqa: F401
    edge_weight,
    huber_denoise,
    variational_disparity_denoise,
)
from .speckle import connected_components, filter_speckles  # noqa: F401
from .sgbm import sgbm_disparity, sgbm_disparity_banded  # noqa: F401
from .bm import bm_disparity  # noqa: F401
from .tgv import diffusion_tensor, tgv2_refine  # noqa: F401
from .nltgv import nl2tgv_refine  # noqa: F401
from .mst import (  # noqa: F401
    aggregation_norm_inv,
    forest_arrays,
    mst_pms_optimize,
    tree_filter,
)
from .segmentation import boruvka_segment, segment_image  # noqa: F401
