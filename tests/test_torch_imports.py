"""The port never imports jax: the GPU machine has none. Every module of
stereomatch_tpu_torch, and chip_smoke.py, imports in a process where any
import of jax raises, and no port source names jax in an import. Nor does
the port import anything of the JAX package, not even its framework-free
modules: it keeps its own copies (config.py, synthetic.py)."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "stereomatch_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_BLOCK_JAX = """
import importlib.abc, pkgutil, sys
class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked: " + name)
sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, {root!r})
import stereomatch_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(stereomatch_tpu_torch.__path__, "stereomatch_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
jax_pkg = sorted(k for k in sys.modules if k.split(".")[0] == "stereomatch_tpu")
assert not jax_pkg, jax_pkg
print(" ".join(mods))
"""


def test_port_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCK_JAX.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    # every module was walked, parallel/ included
    want = {".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
            for p in PORT.rglob("*.py")} - {PORT.name}
    assert set(out.stdout.split()) == want


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import\s+jax|from\s+jax[\s.])", src, re.M), path
    assert not re.search(r"^\s*(import|from)\s+stereomatch_tpu\b", src, re.M), path
