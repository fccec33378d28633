"""Multi-device layer on `torch.distributed`: process-group meshes, halo
exchange, tiled pipelines (port of `stereomatch_tpu/parallel/`).

The reference is one process on one GPU (SURVEY.md §2.4-2.5); its
parallelism axes (OpenMP rows, CUDA blocks, disparity-slice streams, dual
L/R streams) map onto a `Mesh` of named axes over the ranks of a process
group (mesh.py), one rank a device:

  "frame"  data parallel over stereo pairs (the streaming-video config)
  "tile"   image rows; windowed ops exchange halos with the neighbours
  "tile_y" x "tile_x" x "dslab"  2-D image tiles plus the H x W x D volume
           split over disparity slabs, the WTA one argmin-combine
  "host"   frames over hosts (multihost.py)
  "cand", "node"  3DMST candidates and cost-volume rows (mst_mesh.py)

Each builder returns a callable that takes the whole inputs on every rank
and gives the whole outputs back on every rank of the mesh. The backend
follows the device: NCCL on the card, gloo on the CPU.
"""

from .mesh import make_mesh, tile_rows_sharding  # noqa: F401
from .halo import halo_exchange_rows  # noqa: F401
from .tiled import tiled_cost_volume_batch, tiled_cost_volume_stereo  # noqa: F401
from .tiled2d import make_mesh3, tiled2d_cost_volume_stereo  # noqa: F401
from .dslab import wta_disparity_dslab  # noqa: F401
from .multihost import (  # noqa: F401
    distributed_init,
    make_host_mesh,
    tiled2d_cost_volume_batch,
)
from .sgbm_mesh import sgbm_batch_mesh  # noqa: F401
from .sgbm_pipeline import sgbm_pipeline_mesh  # noqa: F401
