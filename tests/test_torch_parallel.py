"""The port's parallel/ on a spawned world of 8 CPU processes over gloo
(`parallel.launch.spawn`; the rank bodies, the cases' shapes and their
seeded inputs are in tests/torch_mesh_ranks.py, which imports no jax),
held against the port's single-process functions and against the JAX
package's meshes on the same inputs and layouts, on the 8 virtual CPU
devices of tests/conftest.py.

Tolerances are the JAX package's own for its meshes (tests/test_parallel.py):
the cost-volume pipelines at most 1% of pixels beyond 0.02 px (the box
filters' cumsums run over other extents, which the parabola fit's
division and WTA near-ties amplify), the halo exchange exact, the dslab
WTA bit for bit against `wta_disparity` (the JAX mesh within 1e-6), the
frame-parallel SGBM within 1e-5 px of `sgbm_disparity` frame by frame with
validity exact. Every rank of a case's mesh returns the same maps, bit for
bit. The world has a deadline (WORLD_TIMEOUT) and a timeout per collective.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_mesh_ranks as ranks
from stereomatch_tpu import config as jconfig
from stereomatch_tpu import parallel as jpar
from stereomatch_tpu.parallel.multihost import tiled2d_cost_volume_batch as j_tiled2d_batch
from stereomatch_tpu.parallel.tiled import shard_map
from stereomatch_tpu_torch import config as tconfig
from stereomatch_tpu_torch import parallel as tpar
from stereomatch_tpu_torch.models.costvolume import cost_volume_stereo
from stereomatch_tpu_torch.ops.select import wta_disparity
from stereomatch_tpu_torch.ops.sgbm import sgbm_disparity
from stereomatch_tpu_torch.parallel.launch import spawn

WORLD_TIMEOUT = 240.0  # seconds for the whole 8-rank world (about 7 s here)


@pytest.fixture(scope="module")
def world():
    return spawn(ranks.parallel_world, 8, timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def cpus():
    try:
        devs = jax.devices("cpu")
    except RuntimeError:
        devs = []
    if len(devs) < 8:
        pytest.skip("needs the virtual 8-device CPU mesh")
    return devs


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_disp_close(a, b, atol=0.02, tie_frac=0.01):
    diff = np.abs(np.asarray(a) - np.asarray(b))
    flipped = diff > atol
    assert flipped.mean() <= tie_frac, (
        f"{flipped.mean():.4f} of pixels differ by >{atol} (max {diff.max():.3f})")


def _maps(world, name, n_ranks):
    """The case's outputs from the world, after checking that every rank
    of its mesh returned the same ones."""
    out = []
    for i in range(2):
        key = f"{name}/{i}"
        if key not in world:
            break
        assert int(world[f"ranks/{key}"]) == n_ranks, (key, int(world[f"ranks/{key}"]))
        out.append(world[key].numpy())
    return out


def _jax_cv(name, cpus):
    """The JAX package's mesh on case `name`."""
    layout, shape, b, h, w, _, _, iters, lr = ranks.CV_CASES[name]
    cfg, denoise = ranks.cv_config(jconfig, name), iters is not None
    if layout == "tiled":
        fn = jpar.tiled_cost_volume_stereo(jpar.make_mesh(4, devices=cpus[:4]), cfg, denoise)
    elif layout == "tiled_batch":
        fn = jpar.tiled_cost_volume_batch(jpar.make_mesh(2, 2, devices=cpus[:4]), cfg, denoise)
    elif layout == "tiled2d":
        fn = jpar.tiled2d_cost_volume_stereo(jpar.make_mesh3(*shape, devices=cpus), (h, w), cfg,
                                             denoise, lr)
    else:
        fn = j_tiled2d_batch(jpar.make_host_mesh(*shape, devices=cpus), (h, w), cfg, denoise, lr)
    return [np.asarray(x) for x in fn(*ranks.cv_input(name))]


def _whole(name):
    """The port's single-process pipeline, frame by frame: (B, H, W) maps
    of both views (B = 1 for a one-frame case)."""
    _, _, b, *_, iters, lr = ranks.CV_CASES[name]
    cfg = ranks.cv_config(tconfig, name)
    lefts, rights = (x[None] if b is None else x for x in ranks.cv_input(name))
    outs = [cost_volume_stereo(torch.from_numpy(l), torch.from_numpy(r), cfg, iters is not None, lr)
            for l, r in zip(lefts, rights)]
    return [np.stack([o[i].numpy() for o in outs]) for i in (0, 1)]


def test_halo_exchange_rows(world, cpus):
    (got,) = _maps(world, "halo", 4)
    x = ranks.halo_input()
    m = jpar.make_mesh(4, devices=cpus[:4])
    want = shard_map(lambda blk: jpar.halo_exchange_rows(blk, ranks.HALO, "tile"), mesh=m,
                     in_specs=P("tile"), out_specs=P("tile"))(x)
    np.testing.assert_array_equal(got, np.asarray(want))
    got = got.reshape(4, 8, 2)  # tile 1: rows 2-3 (halo), 4-7, 8-9 (halo)
    np.testing.assert_array_equal(got[1], x[2:10])
    np.testing.assert_array_equal(got[0, :2], 0.0)  # the global edges zero-filled
    np.testing.assert_array_equal(got[3, 6:], 0.0)


def test_wta_dslab_bitwise(world, cpus):
    (got,) = _maps(world, "dslab", 4)
    vol = ranks.dslab_input()
    np.testing.assert_array_equal(got, wta_disparity(torch.from_numpy(vol),
                                                     ranks.DSLAB_MIN_DISP).numpy())
    m = jpar.make_mesh3(1, 1, 4, devices=cpus[:4])
    fn = shard_map(lambda v: jpar.wta_disparity_dslab(v, ranks.DSLAB_MIN_DISP, "dslab"), mesh=m,
                   in_specs=P(None, None, "dslab"), out_specs=P())
    np.testing.assert_allclose(got, np.asarray(jax.jit(fn)(vol)), atol=1e-6)


def test_sgbm_batch_mesh(world, cpus):
    disp, valid = _maps(world, "sgbm_batch", 4)
    left, right = ranks.sgbm_batch_input()
    cfg = tconfig.SGBMConfig(**ranks.SGBM_BATCH)
    for k in range(left.shape[0]):
        ref = sgbm_disparity(torch.from_numpy(left[k]), torch.from_numpy(right[k]), cfg)
        np.testing.assert_allclose(disp[k], ref.disparity.numpy(), atol=1e-5)
        np.testing.assert_array_equal(valid[k], ref.valid.numpy())
    m = jpar.make_mesh(n_tile=1, n_frame=4, devices=cpus[:4])
    jd, jv = jpar.sgbm_batch_mesh(m, jconfig.SGBMConfig(**ranks.SGBM_BATCH))(left, right)
    np.testing.assert_allclose(disp, np.asarray(jd), atol=1e-5)
    np.testing.assert_array_equal(valid, np.asarray(jv))


@pytest.mark.parametrize("name", list(ranks.CV_CASES))
def test_cost_volume_mesh(world, cpus, name):
    """tiled (frame 1 x tile 4, with and without denoise), the tiled batch
    (frame 2 x tile 2), tiled2d (2, 2, 2) with and without denoise and with
    lr_check, and the host batch (2, 2, 2, 1) with denoise and with
    lr_check: against the port's whole frames and the JAX mesh."""
    layout, shape, b, *_ = ranks.CV_CASES[name]
    got = _maps(world, name, int(np.prod(shape)))
    whole = _whole(name)
    jax_maps = _jax_cv(name, cpus)
    for g, w, j in zip(got, whole, jax_maps):
        g = g[None] if b is None else g
        j = j[None] if b is None else j
        assert g.shape == w.shape == j.shape and np.isfinite(g).all()
        for k in range(g.shape[0]):
            _assert_disp_close(g[k], w[k])
            _assert_disp_close(g[k], j[k])


def test_make_mesh_default_and_one_rank_group(tmp_path):
    """Alone, a mesh starts a one-rank gloo group: every rank on the tile
    axis, and the builders run through it."""
    mesh = tpar.make_mesh(device="cpu")
    assert mesh.shape == {"frame": 1, "tile": 1} and mesh.member
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(tpar.tile_rows_sharding(mesh)(x), x)
    np.testing.assert_array_equal(tpar.halo_exchange_rows(x, 2, mesh)[2:-2].numpy(), x.numpy())
    assert tpar.distributed_init(device="cpu") is False  # no launcher environment: alone
    with pytest.raises(RuntimeError, match="gloo"):
        tpar.make_mesh3(1, 1, 1, device="cuda:0")  # the group's backend is not NCCL


def test_distributed_init_joins_torchrun_environment(tmp_path):
    """With torchrun's environment (here a world of one on a localhost
    port), distributed_init joins the group on the device's backend and a
    mesh then takes its ranks; run in a fresh interpreter, whose group
    nothing else shares."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="1",
               RANK="0", LOCAL_RANK="0", PYTHONPATH=root)
    code = ("import torch.distributed as dist\n"
            "from stereomatch_tpu_torch.parallel import distributed_init, make_mesh\n"
            "assert distributed_init(device='cpu') is True\n"
            "mesh = make_mesh(device='cpu')\n"
            "print(dist.get_backend(), dist.get_world_size(), mesh.shape)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path), timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[0] == "gloo 1 {'frame': 1, 'tile': 1}"
