"""Build and load the port's CUDA kernels (csrc/*.cu) for Hopper.

The kernels build at first use, from the sources in this checkout, into
`build/torch_ext/` at the repository root, and only when a CUDA tensor
reaches a kernel wrapper: importing the package needs neither a GPU nor
nvcc. With `ninja` on PATH the build is one
`torch.utils.cpp_extension.load` call (the four .cu files, K1's
`sgbm_aggregate.cu`, K2's `seg_scan.cu`, K3's `threefry.cu` and K4's
`guided_filter.cu`, plus the one binding file that includes
torch/extension.h); without it, the same five sources are compiled by one
`nvcc -shared` command into the same Python extension module. Both target
`sm_90a`.
"""

from __future__ import annotations

import functools
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

__all__ = ["load_kernels", "BUILD_DIR"]

_NAME = "stereomatch_tpu_torch_kernels"
_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_ext"
_SOURCES = ("bindings.cpp", "sgbm_aggregate.cu", "seg_scan.cu", "threefry.cu",
            "guided_filter.cu")
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"


def _load_with_ninja(verbose: bool):
    from torch.utils.cpp_extension import load

    return load(
        name=_NAME,
        sources=[str(_CSRC / s) for s in _SOURCES],
        build_directory=str(BUILD_DIR),
        extra_cflags=["-O2"],
        extra_cuda_cflags=["-O3", _ARCH, "-std=c++17"],
        verbose=verbose,
    )


def _load_with_nvcc(verbose: bool, build_dir: Path = BUILD_DIR):
    """One nvcc command builds the extension module (no ninja needed).
    tests/test_torch_kernels_cuda.py builds and runs this route on its own."""
    import torch
    from torch.utils.cpp_extension import CUDA_HOME, include_paths, library_paths

    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / (_NAME + sysconfig.get_config_var("EXT_SUFFIX"))
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    cmd = [nvcc, "-O3", "-std=c++17", _ARCH, "-shared", "-Xcompiler", "-fPIC",
           f"-DTORCH_EXTENSION_NAME={_NAME}", "-DTORCH_API_INCLUDE_EXTENSION_H",
           f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
           f"-I{sysconfig.get_paths()['include']}"]
    cmd += [f"-I{p}" for p in include_paths(device_type="cuda")]
    cmd += [str(_CSRC / s) for s in _SOURCES]
    for p in library_paths(device_type="cuda"):
        cmd += [f"-L{p}", f"-Xlinker=-rpath={p}"]
    cmd += ["-lc10", "-lc10_cuda", "-ltorch", "-ltorch_cpu", "-ltorch_cuda",
            "-ltorch_python", "-o", str(out)]
    if verbose:
        print(" ".join(cmd), file=sys.stderr)
    subprocess.run(cmd, check=True)
    spec = importlib.util.spec_from_file_location(_NAME, out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def load_kernels(verbose: bool = False):
    """The compiled kernel module (K1 `sgbm_aggregate`; K2 `seg_scan`,
    `ancestor_sums` and `seg_scan_plan`; K3 `threefry_keys` and
    `threefry_uniform`; K4 `guided_filter`), built on the first call in this
    process. Raises if the build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return _load_with_ninja(verbose) if shutil.which("ninja") else _load_with_nvcc(verbose)
