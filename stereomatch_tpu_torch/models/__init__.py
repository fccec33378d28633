"""Model compositions of the port, one per stereo engine ported so far:

  costvolume  — AD+gradient volume + guided filter + WTA + Huber denoise
                (ref: costVolumeStereoPlusVariationalDenoise,
                src/PatchMatchStereoGPU.cu:8776-9410)
  coupled     — PatchMatch over a cost volume alternating with Huber-ROF
                smoothing of the (d, nx, ny) fields, and the AL-TGV <->
                coupled-WTA alternation
  patchmatch  — slanted-plane PatchMatch with the plane fill and the
                colour-weighted median (ref: PatchMatchStereoGPU)
  mst         — Stereo3DMST segment-tree aggregation (flat, fused,
                coarse-to-fine, seeded) and its helpers
  sgbm_mst    — the SGBM-seeded 3DMST frame, the temporal (video) frame
                and the offline compositions
"""

from .costvolume import cost_volume_stereo, CostVolumeOutput  # noqa: F401
from .mst import (  # noqa: F401
    MSTOutput,
    mst_stereo,
    mst_stereo_c2f,
    mst_stereo_fused,
    mst_stereo_seeded,
)
from .coupled import (  # noqa: F401
    CoupledOutput,
    coupled_patchmatch_stereo,
    coupled_wta_stereo,
)
