"""stereomatch_tpu_torch — the PyTorch + CUDA port of stereomatch_tpu.

The JAX package (`stereomatch_tpu/`) is the reference; this package mirrors
its layout (`ops/`, `models/`, `apps/`, `serving.py`) with plain functions
on torch tensors. Every Pallas kernel on the ported path is a hand-written
Hopper kernel under `csrc/` with a plain PyTorch twin beside it: a wrapper
launches its kernel for CUDA tensors and runs the twin only for CPU
tensors. Kernels build at first use (`_build.py`), never at import.

The package imports nothing of the JAX package. `config.py` holds its own
copy of the frozen configs (`MSTConfig`, `SGBMConfig`, ...), field for field
the JAX package's, and `synthetic.py` its own copy of the ground-truth
scenes, pixel for pixel the JAX package's. Public entry points run on the
card (`device="cuda"`) unless the caller passes another device.
"""

__version__ = "0.1.0"
