"""The port's band-pipelined SGBM (parallel/sgbm_pipeline.py, one K1c step
a band and frame) on a spawned world of 4 CPU processes over gloo, one
band each (tests/torch_mesh_ranks.py), held against the port's
single-process functions and against the JAX package's pipelined mesh on 4
virtual CPU devices, on the same seeded float gray frames.

Tolerances: the pipeline equals the port's band driver
(`sgbm_disparity_banded` with bands of H / 4 rows) bit for bit: the same
band costs, carries and selection. Against the whole frame
(`sgbm_disparity`) and against the JAX mesh, at most 0.2% of pixels flip
(validity, or more than 1e-4 px): band-local float32 cost sums can differ
from the whole frame's by an ulp and flip a near-exact tie (the bound of
tests/test_sgbm_pipeline_mesh.py). The bf16 cost is held as
tests/test_torch_sgbm.py holds bf16 SGBM, D1 under 0.5%: against the JAX
mesh, since the port keeps the DP state and K1c's carry in float32 where
the JAX package keeps the cost's dtype, and against the whole frame, since
rounding to bf16 turns the band sums' ulp into up to a bf16 step (0.21%
of one frame's pixels flip here).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_mesh_ranks as ranks
from stereomatch_tpu.config import SGBMConfig as JSGBMConfig
from stereomatch_tpu.parallel.sgbm_pipeline import sgbm_pipeline_mesh as j_pipeline
from stereomatch_tpu_torch.config import SGBMConfig
from stereomatch_tpu_torch.ops.sgbm import sgbm_disparity, sgbm_disparity_banded
from stereomatch_tpu_torch.parallel.launch import spawn

WORLD_TIMEOUT = 180.0  # seconds for the whole 4-rank world (about 5 s here)


@pytest.fixture(scope="module")
def world():
    return spawn(ranks.sgbm_pipeline_world, ranks.PIPE_BANDS, timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def jax_mesh():
    try:
        cpus = jax.devices("cpu")
    except RuntimeError:
        cpus = []
    if len(cpus) < ranks.PIPE_BANDS:
        pytest.skip("needs the virtual 8-device CPU mesh")
    return Mesh(np.array(cpus[:ranks.PIPE_BANDS]), ("tile",))


def _assert_held(disp, valid, ref_disp, ref_valid, cost_dtype):
    """float32: at most 0.2% of pixels flipped; bf16: D1 under 0.5% where
    both maps are valid, on over half the pixels."""
    if cost_dtype == "float32":
        flipped = ((valid != ref_valid) | (np.abs(disp - ref_disp) > 1e-4)).mean()
        assert flipped < 0.002, flipped
        return
    both = valid & ref_valid
    assert both.mean() > 0.5
    err = np.abs(disp - ref_disp)[both]
    d1 = ((err > 3.0) & (err > 0.05 * np.abs(ref_disp[both]))).mean()
    assert d1 < 0.005, d1


@pytest.mark.parametrize("name", list(ranks.PIPE_CASES))
def test_pipelined_sgbm(world, jax_mesh, name):
    """8, 5 and 4 paths with a float32 cost, 8 paths with a bf16 cost."""
    for i in range(2):
        assert int(world[f"ranks/{name}/{i}"]) == ranks.PIPE_BANDS
    disp, valid = world[f"{name}/0"].numpy(), world[f"{name}/1"].numpy()
    left, right = ranks.pipe_input(name)
    b, h, w, kw = ranks.PIPE_CASES[name]
    assert disp.shape == valid.shape == (b, h, w) and valid.dtype == bool
    cfg = SGBMConfig(**kw)
    for f in range(b):
        lt, rt = torch.from_numpy(left[f]), torch.from_numpy(right[f])
        band = sgbm_disparity_banded(lt, rt, cfg, band_rows=h // ranks.PIPE_BANDS, device="cpu")
        np.testing.assert_array_equal(disp[f], band.disparity.numpy())
        np.testing.assert_array_equal(valid[f], band.valid.numpy())
        whole = sgbm_disparity(lt, rt, cfg)
        _assert_held(disp[f], valid[f], whole.disparity.numpy(), whole.valid.numpy(),
                     cfg.cost_dtype)
        assert valid[f].mean() > 0.5
    jd, jv = (np.asarray(x) for x in j_pipeline(jax_mesh, JSGBMConfig(**kw))(left, right))
    for f in range(b):
        _assert_held(disp[f], valid[f], jd[f], jv[f], cfg.cost_dtype)
