"""The video server as it ships (`compile_mst_video_server` with its default
guided volume and without `reuse_forest`), on the CPU at 48x64x16, against
the benchmark's reference of it (`portbench/reference/video_rebuild.py`),
which decides the cell `mst_video_rebuild`'s `correct`.

On the CPU every kernel runs its plain twin, the code the reference's
frozen copies froze, so one keyframe group (keyframe, temporal, temporal;
two frames in flight, as the cell serves them) is held bit for bit. The
same server with `reuse_forest`, whose temporal frames refine on the
keyframe's forests, fails that comparison on a temporal frame: the
reference rebuilds them from each frame's own images."""

import json
import pathlib

import numpy as np
import pytest
import torch

from portbench.reference.video_rebuild import mst_video_rebuild_group
from stereomatch_tpu_torch.config import production_mst_config
from stereomatch_tpu_torch.serving import compile_mst_video_server
from stereomatch_tpu_torch.synthetic import render_sequence

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = ROOT / "portbench" / "configs" / "mst_2048x1536_d100_guided_rebuild.json"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spec():
    s = json.loads(CONFIG.read_text())
    s.update(s["rehearsal"])
    return s


@pytest.fixture(scope="module")
def frames(spec):
    seq = render_sequence(3, 3, spec["rows"], spec["cols"], spec["max_disp"], drift=2.0)
    return [(sc.left, sc.right) for sc in seq]


def _server(spec, reuse_forest: bool):
    m, srv = spec["mst"], spec["server"]
    cfg = production_mst_config(
        spec["max_disp"], forest_backend="device", gamma=m["gamma"], c=m["c"],
        min_cc_size=m["min_cc_size"], median_prefilter=m["median_prefilter"],
        max_log_range=m["max_log_range"], carry_iters=m["carry_iters"],
        normalize_aggregation=m["normalize_aggregation"], volume_dtype=m["volume_dtype"])
    kw = dict(reuse_forest=True) if reuse_forest else {}  # the server's default: False
    return compile_mst_video_server(
        spec["rows"], spec["cols"], cfg=cfg, fine_iterations=m["fine_iterations"],
        refine_start=m["refine_start"], temporal_iterations=m["temporal_iterations"],
        temporal_refine_start=m["temporal_refine_start"], max_neighbors=m["max_neighbors"],
        right_seed=m["right_seed"], reseed_every=srv["reseed_every"],
        scene_cut_ratio=srv["scene_cut_ratio"], capacity=srv["capacity"], device="cpu", **kw)


@pytest.mark.parametrize("reuse_forest", [False, True], ids=["as_shipped", "stale_forest"])
def test_video_server_against_the_rebuild_reference(spec, frames, reuse_forest):
    srv = _server(spec, reuse_forest)
    seeds = [11, 12, 13]
    t0, t1 = (srv.submit_pair(*frames[j], seed=seeds[j]) for j in range(2))
    got = [srv.collect(t0)]
    t2 = srv.submit_pair(*frames[2], seed=seeds[2])
    got += [srv.collect(t1), srv.collect(t2)]
    assert srv.scene_cuts == 0 and srv.failures == 0
    want = mst_video_rebuild_group(frames, seeds, got, spec, spec["server"]["scene_cut_ratio"],
                                   device="cpu")
    equal = [all(np.array_equal(g, w) for g, w in zip(gm, wm, strict=True))
             for gm, wm in zip(got, want, strict=True)]
    assert all(g.shape == (spec["rows"], spec["cols"]) for gm in got for g in gm)
    assert equal[0]  # the keyframe builds its forests either way
    if reuse_forest:
        assert not all(equal[1:])  # a temporal frame refined on the keyframe's forests
    else:
        assert all(equal)
