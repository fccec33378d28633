"""Rank bodies of the port's mesh tests (tests/test_torch_parallel.py,
test_torch_mst_mesh.py, test_torch_sgbm_pipeline_mesh.py and the stream
app's mesh test), with the cases' shapes, configs and seeded inputs.

Each `*_world` function runs on every rank of a gloo world that
`stereomatch_tpu_torch.parallel.launch.spawn` starts from a test. This
module imports nothing of jax or of the JAX package, so the spawned ranks
do not either (each checks), and the tests build their JAX side from the
same specs. A world returns rank 0's outputs, the whole maps, with
"ranks/<case>", the number of ranks whose output equals rank 0's bit for
bit (every rank of the case's mesh: each gets the whole maps back).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

# the JAX tests' own shapes and meshes (tests/test_parallel.py,
# test_mst_mesh.py, test_sgbm_pipeline_mesh.py), and the tiled batch on
# "tiled"'s shape: layout, mesh, batch (None: one frame), rows, columns,
# disparities, guided radius, denoise iterations (None: no denoise),
# lr_check
CV_CASES = {
    "tiled": ("tiled", (1, 4), None, 64, 48, 16, 3, 15, False),
    "tiled_nod": ("tiled", (1, 4), None, 32, 40, 8, 2, None, False),
    "tiled_batch": ("tiled_batch", (2, 2), 2, 64, 48, 16, 3, 15, False),
    "tiled2d": ("tiled2d", (2, 2, 2), None, 48, 64, 16, 3, 15, False),
    "tiled2d_nod": ("tiled2d", (2, 2, 2), None, 32, 48, 8, 2, None, False),
    "tiled2d_lr": ("tiled2d", (2, 2, 2), None, 32, 48, 8, 2, None, True),
    "host": ("host", (2, 2, 2, 1), 4, 32, 48, 8, 2, 8, False),
    "host_lr": ("host", (2, 2, 2, 1), 2, 32, 48, 8, 2, None, True),
}
HALO = 2
DSLAB_MIN_DISP = 5
SGBM_BATCH = dict(min_disp=0, num_disp=16, block_size=5)
# pipelined SGBM on 4 bands: frames, rows, columns, config
PIPE_CASES = {
    "p8": (3, 64, 96, dict(min_disp=0, num_disp=16, block_size=5)),
    "p5": (2, 64, 96, dict(min_disp=0, num_disp=16, block_size=5, num_paths=5)),
    "p4": (2, 64, 96, dict(min_disp=0, num_disp=16, block_size=5, num_paths=4)),
    "p8_bf16": (2, 64, 96, dict(min_disp=0, num_disp=16, block_size=5, cost_dtype="bfloat16")),
}
PIPE_BANDS = 4
# mst_mesh: mesh ("cand", n) or ("node", n_cand, n_node), iterations,
# refine_start, the init ("random": init_labels; "shared": the JAX
# package's init_labels handed over; "seeded": planes from the volume's
# WTA with their tree-filtered cost), normalize_aggregation
MST_CASES = {
    "cand2": (("cand", 2), 6, None, "shared", False),
    "cand4": (("cand", 4), 6, None, "shared", False),
    "cand2_random": (("cand", 2), 6, None, "random", False),
    "node2x2": (("node", 2, 2), 6, None, "shared", False),
    "node1x4": (("node", 1, 4), 6, None, "shared", False),
    "node4x2": (("node", 4, 2), 6, None, "shared", False),
    "refine": (("cand", 2), 4, 2.0, "seeded", False),
    "cand2_norm": (("cand", 2), 6, None, "shared", True),
    "node2x2_norm": (("node", 2, 2), 6, None, "shared", True),
}
MST_MAX_DISP = 10
MST_NEIGHBORS = 3


def cv_config(cm, name: str):
    """CostVolumePipelineConfig of case `name` from config module `cm`
    (either package's)."""
    _, _, _, _, _, d, radius, iters, _ = CV_CASES[name]
    kw = dict(volume=cm.CostVolumeConfig(min_disp=0, max_disp=d - 1),
              guided=cm.GuidedFilterConfig(radius=radius, slab=8))
    if iters:
        kw["denoise"] = cm.DenoiseConfig(iterations=iters)
    return cm.CostVolumePipelineConfig(**kw)


def cv_input(name: str):
    """Case `name`'s (left, right) BGR images in [0, 255], (B,) H, W, 3."""
    _, _, b, h, w, *_ = CV_CASES[name]
    rng = np.random.default_rng(list(CV_CASES).index(name))
    shape = (h, w, 3) if b is None else (b, h, w, 3)
    return tuple((rng.random(shape) * 255).astype(np.float32) for _ in range(2))


def halo_input():
    return np.arange(32.0, dtype=np.float32).reshape(16, 2)


def dslab_input():
    """A (13, 21, 16) volume with exact ties across and at slab edges."""
    vol = np.random.default_rng(0).random((13, 21, 16)).astype(np.float32)
    vol[3, 4, 2] = vol[3, 4, 9] = vol[3, 4].min() - 1.0
    vol[7, 7, 7] = vol[7, 7, 8] = vol[7, 7].min() - 1.0
    return vol


def shifted_gray_pair(seed: int, b: int, h: int, w: int, shift: int):
    base = (np.random.default_rng(seed).random((b, h, w + 8)) * 255).astype(np.float32)
    return base[..., :w], base[..., shift:shift + w]


def sgbm_batch_input():
    return shifted_gray_pair(0, 4, 32, 64, 4)


def pipe_input(name: str):
    b, h, w, _ = PIPE_CASES[name]
    return shifted_gray_pair(list(PIPE_CASES).index(name), b, h, w, 5)


def _no_jax():
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "stereomatch_tpu"))
    if loaded:
        raise AssertionError(f"a rank imported jax or the JAX package: {loaded}")


def _agreed(out: dict) -> dict:
    """`out` with "ranks/<case>": how many ranks hold rank 0's output."""
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    counts = {f"ranks/{k}": torch.tensor(sum(
        k in o and torch.equal(o[k], v) for o in every)) for k, v in out.items()}
    return {**out, **counts}


def _keep(out: dict, name: str, res) -> None:
    if res is not None:  # None: a rank outside the case's mesh
        for i, t in enumerate(res):
            out[f"{name}/{i}"] = t


def parallel_world() -> dict:
    """8 ranks: halo, dslab, the frame-parallel SGBM and every cost-volume
    case, each on its own mesh over the first ranks."""
    _no_jax()
    from stereomatch_tpu_torch import config as tcfg
    from stereomatch_tpu_torch import parallel as P
    from stereomatch_tpu_torch.parallel.multihost import tiled2d_cost_volume_batch

    out = {}
    mesh = P.make_mesh(n_tile=4, device="cpu")
    if mesh.member:
        blk = mesh.shard(torch.from_numpy(halo_input()), "tile")
        _keep(out, "halo", [mesh.gather(P.halo_exchange_rows(blk, HALO, mesh), "tile")])
    mesh = P.make_mesh3(1, 1, 4, device="cpu")
    if mesh.member:
        vol = mesh.shard(torch.from_numpy(dslab_input()), "dslab", 2)
        _keep(out, "dslab", [P.wta_disparity_dslab(vol, DSLAB_MIN_DISP, mesh)])
    mesh = P.make_mesh(n_tile=1, n_frame=4, device="cpu")
    _keep(out, "sgbm_batch", P.sgbm_batch_mesh(mesh, tcfg.SGBMConfig(**SGBM_BATCH))(
        *sgbm_batch_input()))
    for name, (layout, shape, b, h, w, _, _, iters, lr) in CV_CASES.items():
        cfg, denoise = cv_config(tcfg, name), iters is not None
        if layout == "tiled":
            fn = P.tiled_cost_volume_stereo(P.make_mesh(*shape[::-1], device="cpu"), cfg, denoise)
        elif layout == "tiled_batch":
            fn = P.tiled_cost_volume_batch(P.make_mesh(*shape[::-1], device="cpu"), cfg, denoise)
        elif layout == "tiled2d":
            fn = P.tiled2d_cost_volume_stereo(P.make_mesh3(*shape, device="cpu"), (h, w), cfg,
                                              denoise, lr)
        else:
            fn = tiled2d_cost_volume_batch(P.make_host_mesh(*shape, device="cpu"), (h, w), cfg,
                                           denoise, lr)
        _keep(out, name, fn(*cv_input(name)))
    return _agreed(out)


def sgbm_pipeline_world() -> dict:
    """PIPE_BANDS ranks, one band each: every PIPE_CASES case."""
    _no_jax()
    from stereomatch_tpu_torch.config import SGBMConfig
    from stereomatch_tpu_torch.parallel import make_mesh, sgbm_pipeline_mesh

    mesh = make_mesh(n_tile=PIPE_BANDS, device="cpu")
    out = {}
    for name, (_, _, _, kw) in PIPE_CASES.items():
        _keep(out, name, sgbm_pipeline_mesh(mesh, SGBMConfig(**kw))(*pipe_input(name)))
    return _agreed(out)


def mst_config(cm, name: str):
    """MSTConfig of case `name` from config module `cm`."""
    _, iters, _, _, norm = MST_CASES[name]
    return cm.MSTConfig(max_disp=MST_MAX_DISP, iterations=iters, normalize_aggregation=norm)


def mst_world(problem_path: str) -> dict:
    """8 ranks: every MST_CASES case on its (cand) or (cand, node) mesh;
    `problem_path` holds the forest's fields, the volume, the key and the
    shared and seeded inits (an .npz the test writes)."""
    _no_jax()
    from stereomatch_tpu_torch import config as tcfg
    from stereomatch_tpu_torch.parallel import mst_mesh

    f, vol, key, inits = mst_problem(problem_path, "cpu")
    out = {}
    for name, (layout, iters, refine_start, init, _) in MST_CASES.items():
        cfg = mst_config(tcfg, name)
        kw = dict(max_neighbors=MST_NEIGHBORS, iterations=iters, init_state=inits.get(init),
                  refine_start=refine_start)
        if layout[0] == "cand":
            mesh = mst_mesh.make_cand_mesh(layout[1], device="cpu")
            res = mst_mesh.mst_pms_optimize_mesh(key, vol, f, mesh, cfg, **kw)
        else:
            mesh = mst_mesh.make_cand_node_mesh(*layout[1:], device="cpu")
            res = mst_mesh.mst_pms_optimize_mesh_sharded(
                key, mst_mesh.volume_in_node_order(vol, f), f, mesh, cfg, **kw)
        _keep(out, name, res)
    return _agreed(out)


def mst_problem(path: str, device: str = "cpu"):
    """(ForestArrays, volume, key, {"shared": ..., "seeded": ...}) on the
    port's side from the test's .npz: forest fields "forest/<name>"."""
    from stereomatch_tpu_torch.interop import native_forest_from_numpy
    from stereomatch_tpu_torch.ops.mst import forest_arrays

    z = np.load(path)
    forest = native_forest_from_numpy(
        {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith("forest/")})
    t = {k: torch.from_numpy(z[k]).to(device) for k in z.files if not k.startswith("forest/")}
    inits = {name: tuple(t[f"{name}/{i}"] for i in range(4)) for name in ("shared", "seeded")}
    return forest_arrays(forest, device), t["vol"], t["key"], inits


def stream_world(data_dir: str, calib: str, out_dir: str, kw: dict) -> dict:
    """`apps.stream.run(..., **kw)` on the world's ranks (2: frame 1 x tile 2)."""
    _no_jax()
    from stereomatch_tpu_torch.apps import stream

    dl = stream.run(data_dir, calib, out_dir, device="cpu", **kw)
    return _agreed({"dl": torch.from_numpy(dl)})
