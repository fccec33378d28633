"""Build the host forest builder (treebuild.cpp) as a shared library:
`python -m stereomatch_tpu_torch.native.build`.

The library goes to `build/native/` at the repository root, never next to
the sources, under a name that carries a hash of the source, the flags
and the target g++ resolves `-march=native` to on this host, so an edited
source builds anew, an unchanged one is reused, and a build directory
copied to a host of another instruction set is not loaded there. g++ writes to a
temporary file of its own first and `os.replace` publishes the result,
so processes (or threads) that build at the same time each see either no
library or a whole one.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCE", "build"]

SOURCE = Path(__file__).resolve().parent / "treebuild.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


def build(verbose: bool = False) -> str:
    """Path of the compiled library, built now if this source, these flags
    and this host's target have none."""
    target = subprocess.run(["g++", *FLAGS, "-Q", "--help=target"], check=True,
                            capture_output=True).stdout
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode() + target).hexdigest()[:16]
    lib = BUILD_DIR / f"libtreebuild-{digest}.so"
    if lib.exists():
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    tmp = Path(tmp)
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(SOURCE)]
    if verbose:
        print("+", " ".join(cmd), file=sys.stderr)
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose, text=True)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return str(lib)


if __name__ == "__main__":
    print(build(verbose=True))
