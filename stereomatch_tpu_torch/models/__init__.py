"""Model compositions of the port, one per stereo engine ported so far:

  costvolume  — AD+gradient volume + guided filter + WTA + Huber denoise
                (ref: costVolumeStereoPlusVariationalDenoise,
                src/PatchMatchStereoGPU.cu:8776-9410)
  mst         — Stereo3DMST segment-tree aggregation and its helpers
  sgbm_mst    — the SGBM-seeded 3DMST frame, the temporal (video) frame
                and the offline compositions
"""

from .costvolume import cost_volume_stereo, CostVolumeOutput  # noqa: F401
