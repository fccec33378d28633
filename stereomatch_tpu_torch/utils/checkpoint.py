"""Checkpoint / resume for long-running optimizers (port of
`stereomatch_tpu/utils/checkpoint.py`).

The reference has NO checkpointing (SURVEY.md §5): its only persistent
intermediate state is image files and the mc-cnn left.bin/right.bin cost
volumes (which io/costvolume.py reads/writes). This module snapshots the
MST plane-label state or PatchMatch plane state to a single .npz and
resumes optimization from it, e.g. 50 MST_PMS iterations, a checkpoint,
50 more later.
"""

from __future__ import annotations

import numpy as np

from ..io.images import to_numpy

__all__ = ["save_state", "load_state"]


def save_state(path: str, **arrays) -> None:
    """Save named arrays (tensors on any device, or numpy) to one .npz
    checkpoint."""
    np.savez_compressed(path, **{k: to_numpy(v) for k, v in arrays.items()})


def load_state(path: str) -> dict:
    """Load a checkpoint into a dict of numpy arrays."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
