"""The port's spans (`stereomatch_tpu_torch/utils/timing.py::span`) and the
benchmark's readers of them (`portbench/spans.py`, `portbench/metrics/`).

With no profiler running a span is one shared no-op. Under a profiler the
spans are function-scope CPU events (not user annotations), nested as the
program's layers nest, and counted as the paths run them. The readers are
held to hand-built traces, where every value is known exactly and each
layer's charges plus the unattributed part sum to the trace's totals.

The file imports neither jax nor anything from conftest, so the test
marked `cuda` also runs on a GPU machine without jax:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q
"""

import ast
import importlib.util
import pathlib
import sys
from contextlib import nullcontext
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spans as pspans  # noqa: E402
from portbench.tracing import Trace  # noqa: E402
from stereomatch_tpu_torch import pipelines  # noqa: E402
from stereomatch_tpu_torch.config import SGBMConfig, production_mst_config  # noqa: E402
from stereomatch_tpu_torch.ops.sgbm import sgbm_disparity_banded  # noqa: E402
from stereomatch_tpu_torch.serving import (  # noqa: E402
    compile_mst_video_server, compile_sgbm_mst_server,
)
from stereomatch_tpu_torch.synthetic import render_scene, render_sequence  # noqa: E402
from stereomatch_tpu_torch.utils.timing import SPANS, StageTimer, span  # noqa: E402

H, W, D = 40, 56, 16
CFG = production_mst_config(D, on_tpu=False, min_cc_size=20, c=800.0, forest_backend="device")
KW = dict(cfg=CFG, fine_iterations=3, refine_start=2.0, device="cpu", volume_guided=False)


def _events(prof):
    return [e for e in prof.events() if e.name.startswith("sm.")]


def _names(prof) -> list[str]:
    return [e.name for e in _events(prof)]


def _enclosing(e) -> str | None:
    """The name of the nearest `sm.` span around event `e`."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("sm."):
        p = p.cpu_parent
    return None if p is None else p.name


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


# ---- the helper ----

def test_span_without_a_profiler_is_one_shared_no_op():
    a, b = span("sm.volume"), span("sm.refine")
    assert a is b and isinstance(a, nullcontext)
    with a, b:  # re-entrant
        pass


def test_span_under_a_profiler_is_a_function_event():
    def body():
        with span("sm.forest"):
            with span("sm.forest.round"):
                torch.ones(3).sum()

    prof, _ = _traced(body)
    ev = {e.name: e for e in _events(prof)}
    assert set(ev) == {"sm.forest", "sm.forest.round"}
    assert not any(e.is_user_annotation for e in ev.values())
    assert _enclosing(ev["sm.forest.round"]) == "sm.forest"
    assert span("sm.forest") is span("sm.refine")  # the profiler is off again


def test_every_span_the_package_opens_is_named_in_SPANS():
    """The names are a fixed set: every literal `span("...")` in the
    package is in SPANS, and every name of SPANS is opened somewhere."""
    used = set()
    for path in (ROOT / "stereomatch_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "span" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                used.add(node.args[0].value)
    assert used == SPANS
    assert all(n.count(".") in (1, 2) and n.startswith("sm.") for n in SPANS)


def test_stage_timer_opens_an_app_span_and_keeps_its_report(capsys):
    t = StageTimer(verbose=True)
    prof, out = _traced(lambda: t.time("rectify", lambda: torch.zeros(2) + 1))
    assert out.tolist() == [1.0, 1.0] and _names(prof) == ["sm.app.rectify"]
    with t.stage("cloud"):
        pass
    assert set(t.stages) == {"rectify", "cloud"} and "rectify:" in capsys.readouterr().out
    assert "cloud:" in t.report()


# ---- the paths at a rehearsal size ----

@pytest.fixture(scope="module")
def pair_trace():
    """Two frames of the pair server, two in flight, under the profiler."""
    scenes = [render_scene(s, H, W, D) for s in (1, 2)]
    srv = compile_sgbm_mst_server(H, W, capacity=2, **KW)
    srv.collect(srv.submit_pair(scenes[0].left, scenes[0].right))  # warm

    def serve():
        tickets = [srv.submit_pair(sc.left, sc.right) for sc in scenes]
        return [srv.collect(t) for t in tickets]

    prof, _ = _traced(serve)
    return prof


def test_pair_frames_spans_nest_as_the_layers(pair_trace):
    ev = _events(pair_trace)
    assert not any(e.is_user_annotation for e in ev)
    parents = {}
    for e in ev:
        parents.setdefault(e.name, set()).add(_enclosing(e))
    assert parents["sm.server.submit"] == {None}
    assert parents["sm.server.collect"] == {None}
    for name in ("sm.volume", "sm.sgbm", "sm.forest", "sm.refine"):
        assert parents[name] == {"sm.server.submit"}, name
    assert parents["sm.forest.round"] <= {"sm.forest", "sm.forest.round"}
    assert parents["sm.refine.iter"] == {"sm.refine"}
    # the frame key in submit_pair, the view keys, then the refine's draws
    assert parents["sm.rng"] == {"sm.server.submit", "sm.refine", "sm.refine.iter"}


def test_pair_frames_span_counts(pair_trace):
    names = _names(pair_trace)
    per_frame = {n: names.count(n) / 2 for n in set(names)}
    assert per_frame["sm.server.submit"] == per_frame["sm.server.collect"] == 1
    assert per_frame["sm.volume"] == per_frame["sm.sgbm"] == 1
    assert per_frame["sm.forest"] == per_frame["sm.refine"] == 2
    assert per_frame["sm.refine.iter"] == 2 * KW["fine_iterations"]
    assert per_frame["sm.forest.round"] > 10  # host-checked rounds of both views


def test_video_keyframe_builds_forests_and_the_temporal_frame_none():
    """reuse_forest: the keyframe opens two sm.forest spans, the temporal
    frame none; sm.refine.iter counts each view's iterations."""
    seq = render_sequence(2, 2, H, W, D, drift=1.0)
    srv = compile_mst_video_server(H, W, temporal_iterations=2, reuse_forest=True, **KW)
    counts = []
    for sc in seq:
        prof, _ = _traced(lambda sc=sc: srv.collect(srv.submit_pair(sc.left, sc.right)))
        names = _names(prof)
        counts.append({n: names.count(n) for n in ("sm.forest", "sm.forest.round", "sm.sgbm",
                                                   "sm.refine", "sm.refine.iter")})
    key, temporal = counts
    assert key["sm.forest"] == 2 and key["sm.sgbm"] == 1 and key["sm.forest.round"] > 0
    assert key["sm.refine"] == 2 and key["sm.refine.iter"] == 2 * 3
    assert temporal == {"sm.forest": 0, "sm.forest.round": 0, "sm.sgbm": 0, "sm.refine": 2,
                        "sm.refine.iter": 2 * 2}


def test_scene_cut_replay_is_its_own_span():
    srv = compile_mst_video_server(H, W, temporal_iterations=2, scene_cut_ratio=0.99,
                                   reuse_forest=True, **KW)
    a, b = render_scene(2, H, W, D), render_scene(7, H, W, D, n_discs=6)
    srv.collect(srv.submit_pair(a.left, a.right))
    b_right = b.right[:, ::-1].copy()  # an unrelated right view: few LR-valid pixels
    prof, _ = _traced(lambda: srv.collect(srv.submit_pair(b.left, b_right)))
    names = _names(prof)
    assert srv.scene_cuts == 1 and names.count("sm.server.scene_cut") == 1
    cut = next(e for e in _events(prof) if e.name == "sm.server.scene_cut")
    assert _enclosing(cut) == "sm.server.collect"
    # the replay is a keyframe: its seed and forests inside the cut's span
    assert names.count("sm.sgbm") == 1 and names.count("sm.forest") == 2


@pytest.mark.parametrize("rows,band_rows", [(64, 16), (50, 16), (16, 16)])
def test_banded_sgbm_opens_a_span_per_band(rows, band_rows):
    sc = render_scene(3, rows, 96, 32)
    gl, gr = (pipelines._gray255(img[..., ::-1], "cpu") for img in (sc.left, sc.right))
    cfg = SGBMConfig(min_disp=0, num_disp=32, block_size=3)
    prof, _ = _traced(lambda: sgbm_disparity_banded(gl, gr, cfg, band_rows=band_rows,
                                                    device="cpu"))
    names = _names(prof)
    nbands = -(-rows // band_rows)
    assert names.count("sm.sgbm.band") == nbands
    assert names.count("sm.sgbm.band_up") == nbands - 1


def test_sgbm_pipeline_spans_with_the_band_threshold_at_0(monkeypatch):
    monkeypatch.setattr(pipelines, "SGBM_BAND_THRESHOLD_BYTES", 0)
    sc = render_scene(4, 200, 120, 32)
    cfg = SGBMConfig(min_disp=0, num_disp=32, block_size=3, speckle_window_size=20)
    prof, _ = _traced(lambda: pipelines.sgbm_pipeline(sc.left, sc.right, cfg, device="cpu"))
    names = _names(prof)
    assert {n: names.count(n) for n in set(names)} == {
        "sm.sgbm": 1, "sm.sgbm.gray": 2, "sm.sgbm.band": 2, "sm.sgbm.band_up": 1,
        "sm.sgbm.speckle": 1, "sm.sgbm.to_host": 1}
    inner = {e.name: _enclosing(e) for e in _events(prof)}
    assert inner["sm.sgbm"] is None
    assert all(inner[n] == "sm.sgbm" for n in set(names) - {"sm.sgbm"})


# ---- the readers, on a hand-built trace ----

def _op(name, s, e=None):
    return (name, float(s), float(s if e is None else e))


def _hand_trace() -> Trace:
    """Two frames on a 0-100 us timeline. Device busy [0,2] [5,12] [14,23]
    [30,50] [60,91], so idle (2,5) (12,14) (23,30) (50,60) (91,100)."""
    spans = [
        _op("sm.server.submit", 0, 40), _op("sm.rng", 1, 2), _op("sm.volume", 2, 10),
        _op("sm.sgbm", 10, 20), _op("sm.sgbm.band", 12, 16),
        _op("sm.forest", 20, 30), _op("sm.forest.round", 22, 24), _op("sm.forest.round", 25, 27),
        _op("sm.refine", 30, 38), _op("sm.refine.iter", 31, 37), _op("sm.rng", 32, 33),
        _op("sm.server.collect", 40, 45),
        _op("sm.server.submit", 50, 90), _op("sm.volume", 52, 60), _op("sm.forest", 60, 70),
        _op("sm.forest.round", 61, 69), _op("sm.refine", 70, 88), _op("sm.rng", 71, 72),
        _op("sm.server.collect", 92, 98),
    ]
    launches = [_op("cudaLaunchKernel", t) for t in (3, 5, 53, 11, 36, 99)] + [
        _op("cudaLaunchKernelExC", 13), _op("cuLaunchKernel", 23),
        _op("cuLaunchKernelEx", 32.5), _op("cudaLaunchKernel", 1.5),
        _op("cudaLaunchKernel", 71.5)]
    syncs = [_op("cudaStreamSynchronize", t) for t in (23.5, 26, 41)] + [
        _op("cudaEventSynchronize", 65), _op("cudaDeviceSynchronize", 99.5)]
    other = [_op("aten::add", 3, 4), _op("cudaMemcpyAsync", 41, 44), _op("aten::empty", 0, 100)]
    busy = [(0, 2), (5, 12), (14, 23), (30, 50), (60, 91)]
    return Trace(frames=2, keys=2, window_s=1e-4,
                 kernels=[("k", float(s), float(e)) for s, e in busy[:-1]],
                 copies=[("Memcpy HtoD", float(s), float(e)) for s, e in busy[-1:]],
                 cpu_ops=spans + launches + syncs + other, syncs=5, t0_us=0.0, t1_us=100.0)


def _read(name: str, trace):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(SimpleNamespace(trace=trace, spec={}, mix={"stateful": False}, frames=[]))


HAND = {
    "server.submit_ms": 40 / 1e3,
    "server.collect_ms": 5.5 / 1e3,
    "volume.launches_per_frame": 1.5,
    "forest.launches_per_frame": 0.5,
    "refine.launches_per_frame": 0.5,
    "refine.rng_launches_per_frame": 1.0,
    "sgbm.launches_per_frame": 1.0,
    "volume.idle_ms_per_frame": 5.5 / 1e3,
    "forest.idle_ms_per_frame": 3.5 / 1e3,
    "refine.idle_ms_per_frame": 0.0,
    "sgbm.idle_ms_per_frame": 1.0 / 1e3,
    "sgbm.band_idle_ms_per_frame": 1.0 / 1e3,
    "forest.syncs_per_frame": 1.5,
    "forest.rounds_per_frame": 1.5,
    "device.idle_unattributed_pct": 100.0 * 3 / 31,
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_reader_on_a_hand_built_trace(name):
    assert _read(name, _hand_trace()) == HAND[name]


@pytest.mark.parametrize("name", sorted(HAND))
def test_reader_without_program_spans_reads_nothing(name):
    """The trace of a program that opens no span, and no trace at all."""
    tr = _hand_trace()
    tr.cpu_ops = [op for op in tr.cpu_ops if not op[0].startswith("sm.")]
    assert _read(name, tr) is None and _read(name, None) is None


def test_every_new_reader_has_an_entry():
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in HAND:
        assert entries[name]["source"] == "device_trace" and entries[name]["better"] == "lower"
        assert entries[name]["moves"] == "frames_per_s"


def test_layers_and_unattributed_sum_to_the_totals():
    tr = _hand_trace()
    att = pspans.attribute(tr)
    launches = sum(n in pspans.LAUNCHES for n, _, _ in tr.cpu_ops)
    syncs = sum(n in pspans.SYNCS for n, _, _ in tr.cpu_ops)
    assert sum(att.by_layer(att.launches).values()) == launches == 11
    assert sum(att.by_layer(att.syncs).values()) == syncs == 5
    assert att.by_layer(att.launches) == {"volume": 3, "sgbm": 2, "forest": 1, "refine": 1,
                                          "rng": 3, None: 1}
    assert att.by_layer(att.syncs) == {"forest": 3, "server": 1, None: 1}
    assert att.by_layer(att.idle_us) == {"volume": 11, "sgbm": 2, "forest": 7, "server": 8,
                                         None: 3}
    gaps = pspans.idle_gaps([(s, e) for _, s, e in tr.kernels + tr.copies], 0.0, 100.0)
    assert sum(att.idle_us.values()) == sum(b - a for a, b in gaps) == 31


def test_innermost_segments_and_split():
    spans = [(0.0, 10.0, "sm.a"), (2.0, 4.0, "sm.a.b"), (3.0, 6.0, "sm.c"), (12.0, 14.0, "sm.d")]
    seg = pspans.innermost_segments(spans)
    assert seg == [(0.0, 2.0, "sm.a"), (2.0, 4.0, "sm.a.b"), (4.0, 6.0, "sm.c"),
                   (6.0, 10.0, "sm.a"), (12.0, 14.0, "sm.d")]
    starts = [s for s, _, _ in seg]
    assert pspans.split_interval(seg, starts, 1.0, 13.0) == [
        ("sm.a", 1.0), ("sm.a.b", 2.0), ("sm.c", 2.0), ("sm.a", 4.0), (None, 2.0), ("sm.d", 1.0)]
    assert pspans.split_interval(seg, starts, 15.0, 16.0) == [(None, 1.0)]


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1c kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_banded_sgbm_spans_on_the_card(cuda):
    """One traced band-streamed call: a K1c kernel for every band and
    band_up span, each starting after the span that launched it (one
    clock for host spans and device events), and no device event named
    after a span."""
    from torch.autograd import DeviceType

    sc = render_scene(5, 512, 640, 128)
    cfg = SGBMConfig(min_disp=0, num_disp=128, block_size=5)
    gl, gr = (pipelines._gray255(img[..., ::-1], cuda) for img in (sc.left, sc.right))
    sgbm_disparity_banded(gl, gr, cfg, band_rows=128, device=cuda)  # build and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sgbm_disparity_banded(gl, gr, cfg, band_rows=128, device=cuda)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    assert not any(e.name.startswith("sm.") for e in device)
    k1c = sorted((e.time_range.start for e in device if "sgbm_aggregate_kernel" in e.name))
    bands = sorted(e.time_range.start for e in events
                   if e.name in ("sm.sgbm.band", "sm.sgbm.band_up"))
    assert len(k1c) == len(bands) == 2 * 4 - 1
    assert all(k >= s for k, s in zip(k1c, bands))
