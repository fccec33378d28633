"""The port's video path (stereomatch_tpu_torch/serving.py::VideoStreamServer,
compile_mst_video_server, and the compositions of models/sgbm_mst.py and
models/mst.py) on the CPU: program parity with the JAX package on the same
inputs, seeds and forests; the absolute ground-truth gates of the JAX video
tests; and the executor's cadence, scene-cut and replay behaviour. The
longest tests are in tests/test_torch_video_gt.py.

Parity bound: >= 95% of pixels within 0.1 px, the bound of
tests/test_torch_serving.py (float32 sums in other orders can resolve a
near-tie between candidate labels differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.config import MSTConfig, production_mst_config
from stereomatch_tpu.eval import disparity_metrics
from stereomatch_tpu.serving import compile_mst_video_server as j_video_server
from stereomatch_tpu.synthetic import render_sequence, scene_eval_mask
from stereomatch_tpu_torch import random as trandom
from stereomatch_tpu_torch.interop import forest_dict_from_numpy, key_from_jax, video_state_from_jax
from stereomatch_tpu_torch.ops.postprocess import lr_consistency
from stereomatch_tpu_torch.serving import (
    StereoStreamServer,
    VideoStreamServer,
    compile_mst_video_server,
)
from test_torch_config import port_cfg

H, W, D = 48, 64, 16
CFG = production_mst_config(D, on_tpu=False, min_cc_size=20, c=800.0, forest_backend="device")
TCFG = port_cfg(CFG)  # the same fields in the port's own config
# the served-sequence tests of tests/test_serving.py
GH, GW, GD = 120, 160, 24
GCFG = port_cfg(production_mst_config(GD, on_tpu=False, min_cc_size=100, c=2000.0,
                                      forest_backend="device"))
GKW = dict(cfg=GCFG, fine_iterations=4, temporal_iterations=2, temporal_refine_start=4.0,
           device="cpu")


def _close(got, want, bound=0.95):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    share = (np.abs(got - want) < 0.1).mean()
    assert share >= bound, share


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    img = (rng.random((H, W, 3)) * 255).astype(np.float32)
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    return img, np.roll(img, -3, axis=1)


@pytest.fixture(scope="module")
def scenes():
    return render_sequence(3, 3, H, W, D, drift=1.0)


@pytest.fixture(scope="module")
def jax_rf_server():
    """The bench headline deployment in JAX: raw volume, reuse_forest."""
    return j_video_server(H, W, cfg=CFG, reuse_forest=True, volume_guided=False)


# ---- per-program parity with JAX ----

def test_temporal_program_matches_jax(scenes):
    """The rebuild-per-frame temporal program (forests built, no SGBM) on
    frame 1, seeded with the JAX keyframe's maps of frame 0."""
    a, b = scenes[:2]
    js = j_video_server(H, W, cfg=CFG)
    ts = compile_mst_video_server(H, W, cfg=TCFG, device="cpu")
    prev = js.pipeline(jnp.asarray(a.left), jnp.asarray(a.right), jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    want = js.refine_pipeline(jnp.asarray(b.left), jnp.asarray(b.right), *prev, key)
    got = ts.refine_pipeline(_t(b.left), _t(b.right), *map(_t, prev), key_from_jax(key, "cpu"))
    for g, w_ in zip(got, want):
        _close(g.numpy(), w_)


def test_reuse_forest_programs_match_jax_on_jax_forests(scenes, jax_rf_server):
    """The reuse_forest keyframe on frame 0, then the temporal program on
    frame 1 fed the JAX keyframe's maps and its own forests (through
    interop.forest_dict_from_numpy)."""
    a, b = scenes[:2]
    js = jax_rf_server
    ts = compile_mst_video_server(H, W, cfg=TCFG, reuse_forest=True, volume_guided=False,
                                  device="cpu")
    k0, k1 = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
    jdl, jdr, jfl, jfr = js.pipeline(jnp.asarray(a.left), jnp.asarray(a.right), k0)
    tdl, tdr, tfl, tfr = ts.pipeline(_t(a.left), _t(a.right), key_from_jax(k0, "cpu"))
    _close(tdl.numpy(), jdl)
    _close(tdr.numpy(), jdr)
    fl, fr = (forest_dict_from_numpy(_np_tree(f), "cpu") for f in (jfl, jfr))
    for k in ("pixel_of_node", "tree_start", "adj_list", "euler_reset"):
        assert torch.equal(tfl[k], fl[k])  # the forest's integers are exact
    want = js.refine_pipeline(jnp.asarray(b.left), jnp.asarray(b.right), jdl, jdr, jfl, jfr, k1)
    got = ts.refine_pipeline(_t(b.left), _t(b.right), _t(jdl), _t(jdr), fl, fr,
                             key_from_jax(k1, "cpu"))
    for g, w_ in zip(got, want):
        _close(g.numpy(), w_)


def test_sequence_continues_from_jax_state(scenes, jax_rf_server):
    """JAX serves frames 0-1; the port takes its chained state (maps,
    forests, cadence, ticket) and serves frame 2 as JAX does."""
    seq = scenes
    js = jax_rf_server
    js.reset()
    for sc in seq[:2]:
        js.collect(js.submit_pair(sc.left, sc.right))
    ts = compile_mst_video_server(H, W, cfg=TCFG, reuse_forest=True, volume_guided=False,
                                  device="cpu")
    video_state_from_jax(ts, _np_tree(js._prev), [_np_tree(f) for f in js._prev_forest],
                         js._since_key, js._key_frac, js._prev_ticket)
    want = js.collect(js.submit_pair(seq[2].left, seq[2].right))
    t = ts.submit_pair(seq[2].left, seq[2].right)
    assert t == js._prev_ticket and not ts._queue[-1].is_key
    for g, w_ in zip(ts.collect(t), want):
        _close(g, w_)


@pytest.mark.parametrize("entry", ["mst_stereo_temporal_fused", "mst_stereo_seeded",
                                   "sgbm_mst_stereo"])
def test_offline_entry_matches_jax(entry):
    """The inputs of tests/test_mst_video.py::test_mst_temporal_fused_matches_seeded_unfused
    (sgbm_mst_stereo makes its seeds from the pair)."""
    from stereomatch_tpu.models import mst as jm, sgbm_mst as jsm
    from stereomatch_tpu_torch.models import mst as tm, sgbm_mst as tsm

    rng = np.random.default_rng(11)
    bgr_l = rng.random((H, W, 3)).astype(np.float32) * 255
    for _ in range(2):
        bgr_l = (bgr_l + np.roll(bgr_l, 1, 0) + np.roll(bgr_l, 1, 1)) / 3
    bgr_r = np.roll(bgr_l, -3, axis=1)
    vol_l = (rng.random((H, W, D)) * 0.5).astype(np.float32)
    vol_r = (rng.random((H, W, D)) * 0.5).astype(np.float32)
    xs = np.mgrid[0:H, 0:W][1].astype(np.float32)
    prev_l = np.clip(0.1 * xs + 3.0, 0, D - 1)
    prev_r = np.clip(0.1 * xs + 2.5, 0, D - 1)
    cfg = MSTConfig(max_disp=D, iterations=8, min_cc_size=20, c=800.0, forest_backend="device")
    j_fn = getattr(jm if entry == "mst_stereo_seeded" else jsm, entry)
    t_fn = getattr(tm if entry == "mst_stereo_seeded" else tsm, entry)
    seeds = () if entry == "sgbm_mst_stereo" else (prev_l, prev_r)
    args = (bgr_l, bgr_r, vol_l, vol_r, *seeds, cfg)
    kw = dict(seed=0, fine_iterations=3, max_neighbors=4)
    want = j_fn(*args, **kw)
    got = t_fn(*args[:-1], port_cfg(cfg), device="cpu", **kw)
    _close(got.right_disp.numpy(), want.right_disp)
    _close(got.left_disp.numpy(), want.left_disp)
    assert (got.left_valid.numpy() == np.asarray(want.left_valid)).mean() >= 0.95


# ---- absolute ground truth ----

def _gate(dl, dr, sc, d, valid_min, epe_max, bad2_max, tag):
    checked, valid = lr_consistency(_t(dl), _t(dr), float(d), fill=False)
    v = valid.numpy() & scene_eval_mask(sc)
    assert v.mean() > valid_min, (tag, v.mean())
    mm = disparity_metrics(checked.numpy(), sc.disp_left, v)
    assert mm["epe"] < epe_max and mm["bad2"] < bad2_max, (tag, mm)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(reuse_forest=True),
    dict(reuse_forest=True, volume_guided=False),
], ids=["rebuild", "reuse_forest", "raw_reuse_forest"])
def test_served_sequence_absolute_gt(kw):
    """tests/test_serving.py's served-sequence gates (valid > 0.45, EPE <
    0.8 px, bad2 < 3%) on every frame of the 2 px/frame drift sequence."""
    seq = render_sequence(2, 3, GH, GW, GD, drift=2.0)
    srv = compile_mst_video_server(GH, GW, **GKW, **kw)
    tickets = [srv.submit_pair(sc.left, sc.right) for sc in seq]
    assert [p.is_key for p in srv._queue] == [False, False] and 0 in srv._done
    for i, (sc, t) in enumerate(zip(seq, tickets)):
        _gate(*srv.collect(t), sc, GD, 0.45, 0.8, 0.03, (kw, i))


# ---- the executor on toy frame functions ----

class _Poison:
    """An output whose host copy raises, as a failed frame's does."""

    def cpu(self):
        raise RuntimeError("CUDA error: unspecified launch failure")


class _FlakyPipeline:
    """Poisoned outputs for the first `fail_n` calls, then real tensors."""

    def __init__(self, fail_n=1, value=7.0):
        self.fail_n, self.value, self.calls = fail_n, value, 0

    def __call__(self, *args):
        self.calls += 1
        if self.calls <= self.fail_n:
            return _Poison(), _Poison()
        x = torch.full((4, 8), self.value)
        return x, x


class TestFailureReplay:
    """tests/test_serving.py::TestFailureRecovery on the port's executor."""

    def test_retry_replays_lost_frame(self):
        pipe = _FlakyPipeline(fail_n=1)
        server = StereoStreamServer(pipe, "cpu", capacity=2, retries=1)
        a, _ = server.collect(server.submit(np.ones((4, 8), np.float32)))
        np.testing.assert_allclose(a, 7.0)
        assert server.failures == 1 and pipe.calls == 2

    def test_no_retries_propagates(self):
        server = StereoStreamServer(_FlakyPipeline(fail_n=1), "cpu", capacity=1)
        t = server.submit(np.ones((4, 8), np.float32))
        with pytest.raises(RuntimeError, match="launch failure"):
            server.collect(t)

    def test_retries_exhausted_raises(self):
        server = StereoStreamServer(_FlakyPipeline(fail_n=5), "cpu", capacity=1, retries=2,
                                    retry_backoff_s=0.001)
        t = server.submit(np.ones((4, 8), np.float32))
        with pytest.raises(RuntimeError, match="launch failure"):
            server.collect(t)
        assert server.failures == 2

    def test_dispatch_time_failure_recovers_at_submit(self):
        calls = []

        def pipe(*args):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("CUDA error: out of memory")
            x = torch.full((4, 8), 3.0)
            return x, x

        server = StereoStreamServer(pipe, "cpu", capacity=1, retries=1)
        a, _ = server.collect(server.submit(np.ones((4, 8), np.float32)))
        np.testing.assert_allclose(a, 3.0)
        assert server.failures == 1 and len(calls) == 2

    def test_video_refine_crash_replays_as_keyframe(self):
        key_pipe = _FlakyPipeline(fail_n=0, value=100.0)
        ref_calls = []

        def ref_pipe(*args):
            ref_calls.append(1)
            return _Poison(), _Poison()

        server = VideoStreamServer(key_pipe, ref_pipe, "cpu", capacity=2, retries=1)
        x = np.zeros((4, 8), np.float32)
        t0, t1 = server.submit_pair(x, x), server.submit_pair(x, x)
        np.testing.assert_allclose(server.collect(t0)[0], 100.0)
        np.testing.assert_allclose(server.collect(t1)[0], 100.0)
        assert server.failures == 1 and len(ref_calls) == 1 and key_pipe.calls == 2


def _toy_video_server(reseed_every=0, **kw):
    def keyframe(l, r, key):  # marks the keyframe path: maps pinned to 100
        return torch.zeros_like(l) + 100.0, torch.zeros_like(r) + 100.0

    def refine(l, r, pdl, pdr, key):  # marks the temporal path: + 1
        return pdl + 1.0, pdr + 1.0

    return VideoStreamServer(keyframe, refine, "cpu", capacity=2, reseed_every=reseed_every, **kw)


class TestVideoCadence:
    """tests/test_serving.py::TestVideoCadence: the cadence counts frames
    since the last keyframe and reset() rephases it."""

    def test_cadence_counts_from_last_keyframe(self):
        server = _toy_video_server(reseed_every=3)
        x = np.zeros((4, 8), np.float32)
        vals = [float(server.collect(server.submit_pair(x, x))[0][0, 0]) for _ in range(7)]
        assert vals == [100.0, 101.0, 102.0, 100.0, 101.0, 102.0, 100.0]

    def test_reset_rephases_cadence(self):
        server = _toy_video_server(reseed_every=3)
        x = np.zeros((4, 8), np.float32)
        for _ in range(2):
            server.collect(server.submit_pair(x, x))
        server.reset()
        vals = [float(server.collect(server.submit_pair(x, x))[0][0, 0]) for _ in range(4)]
        assert vals == [100.0, 101.0, 102.0, 100.0]


def test_pipelined_cut_does_not_rechain_older_replay():
    """capacity=3: frames 1 and 2 are in flight when frame 1 is graded as a
    cut. Its replay must not re-chain `_prev` or `_prev_forest`: frame 2
    was already seeded from the pre-cut state (the JAX server re-chains the
    forest here, stereomatch_tpu/serving.py:794). A cut on the newest frame
    does re-chain both."""
    def keyframe(l, r, key):  # frame i's keyframe maps: 100 + 10 i; its forest: i
        tag = {"id": l[0, 0, :1] + 0}
        return l[:, :, 0] * 10 + 100.0, r[:, :, 0] * 10 + 100.0, tag, dict(tag)

    def refine(l, r, pdl, pdr, fl, fr, key):
        return pdl + 1.0, pdr + 1.0

    # LR-valid fractions in the order they are taken: frames 0-2 at submit,
    # the replay of frame 1, frame 3 at submit, the replay of frame 3
    fracs = iter([1.0, 0.1, 1.0, 1.0, 0.1, 1.0])
    srv = VideoStreamServer(keyframe, refine, "cpu", capacity=3, reuse_forest=True,
                            scene_cut_ratio=0.6, lr_stat=lambda a, b: torch.tensor(next(fracs)))
    img = [np.full((4, 8, 3), float(i), np.float32) for i in range(4)]
    t0, t1, t2 = (srv.submit_pair(img[i], img[i]) for i in range(3))
    forest0 = srv._prev_forest
    prev2 = srv._prev
    srv.collect(t0)
    dl1, _ = srv.collect(t1)  # graded a cut while frame 2 is in flight
    assert srv.scene_cuts == 1
    np.testing.assert_allclose(dl1, 110.0)  # replayed as a keyframe on frame 1's image
    assert srv._prev_forest is forest0 and srv._prev is prev2
    np.testing.assert_allclose(srv.collect(t2)[0], 102.0)  # frame 2: 100 + 1 + 1
    t3 = srv.submit_pair(img[3], img[3])
    np.testing.assert_allclose(srv.collect(t3)[0], 130.0)  # the newest frame is a cut
    assert srv.scene_cuts == 2 and srv._since_key == 1
    assert float(srv._prev_forest[0]["id"]) == 3.0  # its replay re-chains
    np.testing.assert_allclose(srv._prev[0].numpy(), 130.0)


def test_keyframe_then_temporal_wiring(pair):
    """Temporal frames equal a direct call of the temporal program on the
    previous frame's maps and the frame's key; after reset() a frame
    equals a direct call of the keyframe program."""
    left, right = pair
    srv = compile_mst_video_server(H, W, cfg=TCFG, fine_iterations=2, temporal_iterations=1,
                                   device="cpu")
    t0, t1 = srv.submit_pair(left, right), srv.submit_pair(left, right)
    dl0, dr0 = srv.collect(t0)
    dl1, _ = srv.collect(t1)
    direct, _ = srv.refine_pipeline(_t(left), _t(right), _t(dl0), _t(dr0), trandom.PRNGKey(1, "cpu"))
    np.testing.assert_array_equal(dl1, direct.numpy())
    srv.reset()
    dl, _ = srv.collect(srv.submit_pair(left, right, seed=0))
    np.testing.assert_array_equal(dl, srv.pipeline(_t(left), _t(right), trandom.PRNGKey(0, "cpu"))[0].numpy())


def test_video_unported_options_raise():
    from stereomatch_tpu_torch.models.mst import build_view_forest

    for kw in (dict(staged=True), dict(cache_dir="x")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            compile_mst_video_server(H, W, cfg=TCFG, device="cpu", **kw)
    # the host forest is ported; an unknown backend raises
    with pytest.raises(ValueError, match="forest_backend"):
        build_view_forest(np.zeros((H, W, 3), np.float32),
                          port_cfg(MSTConfig(max_disp=D, forest_backend="gpu")), device="cpu")


@pytest.mark.parametrize("module,name", [
    ("serving", "compile_mst_video_server"),
    ("serving", "compile_sgbm_mst_server"),
    ("serving", "VideoStreamServer"),
    ("models.sgbm_mst", "mst_stereo_temporal_fused"),
    ("models.sgbm_mst", "sgbm_mst_stereo"),
    ("models.sgbm_mst", "sgbm_mst_video"),
    ("models.mst", "mst_stereo_seeded"),
    ("models.mst", "build_view_forest"),
])
def test_entry_keeps_the_jax_names_and_defaults(module, name):
    """Every argument of the JAX entry but the TPU switch exists in the port,
    in the same order, with the same default; the port adds `device`. A
    config default is compared by its class name and fields (each package
    has its own config classes)."""
    import dataclasses
    import importlib
    import inspect

    def default(p):
        v = p.default
        if dataclasses.is_dataclass(v):
            return type(v).__name__, dataclasses.astuple(v)
        return v

    j = inspect.signature(getattr(importlib.import_module(f"stereomatch_tpu.{module}"), name))
    t = inspect.signature(getattr(importlib.import_module(f"stereomatch_tpu_torch.{module}"), name))
    want = [(k, default(p)) for k, p in j.parameters.items() if k != "on_tpu"]
    got = [(k, default(p)) for k, p in t.parameters.items() if k != "device"]
    assert got == want
