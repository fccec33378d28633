"""The cell `mst_video_rebuild`: the video server as it ships (guided volume,
both forests built every frame, no `reuse_forest`), with the reference
`portbench/reference/video_rebuild.py` and the temporal frames' readers
(`portbench/frame_kinds.py`, three metrics).

At the rehearsal size on the CPU: the run prints a well-formed line, the
control fails while the program passes, each planted fault and a stale
forest (the server built with reuse_forest) come out not correct, the
system refuses a configuration with `reuse_forest` or a
stateless mix, and the reference loads nothing of the program. On a
hand-made trace: the readers' counts, what outside a temporal span they
leave out, and None without the span."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from conftest import ROOT, last_line, run_harness
from portbench.faults import MST_FAULTS
from portbench.run import load_module
from portbench.tracing import Trace

CELL, CONFIG = "mst_video_rebuild", "mst_2048x1536_d100_guided_rebuild"
READERS = ("forest.temporal_syncs_per_frame", "forest.temporal_idle_ms_per_frame",
           "server.temporal_submit_ms")


def _spec() -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{CONFIG}.json").read_text())


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_prints_a_well_formed_line(benchmark, trace):
    out = last_line(run_harness("--workload", CELL, "--seed", str(2**31 + 29), "--seconds", "1.5",
                                "--trace", str(trace), "--device", "cpu", "--rehearse"))
    assert list(out)[-1] == "check" and set(out["check"]) == {"gap_share", "gt_worst_pct"}
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 3
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if trace:
        # the CPU trace holds no sync call: the forest's syncs read 0
        assert set(out["metrics"]) == set(READERS)
        assert out["metrics"]["forest.temporal_syncs_per_frame"]["value"] == 0.0
        assert out["metrics"]["server.temporal_submit_ms"]["value"] > 0
    else:
        assert set(out["metrics"]) == {"setup_s", "frames_per_s", "peak_mem_gib", "bad2_pct"}


def test_control_fails_and_the_program_passes():
    proc = run_harness("--workload", CELL, "--seeds", "4", "5", "--control-seeds", "2",
                       "--seconds", "1", "--device", "cpu", "--rehearse",
                       module="portbench.control")
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    limits = summary["limits"]
    assert all(summary["largest_sound"][k] <= v for k, v in limits.items())
    assert any(summary["smallest_control"][k] > v for k, v in limits.items())


@pytest.mark.parametrize("fault", MST_FAULTS)
def test_a_broken_path_is_not_correct(request, capsys, fault):
    from portbench.faults import plant
    from portbench.run import main

    request.addfinalizer(plant(_spec(), fault))
    assert main(["--workload", CELL, "--seed", "31", "--seconds", "1", "--trace", "0",
                 "--device", "cpu", "--rehearse"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"] is False


def test_a_stale_forest_is_not_correct(monkeypatch, capsys):
    """The program's video server built with reuse_forest, so its temporal
    frames refine on the keyframe's forests: the reference, which builds
    them from each frame's own images, tells it apart."""
    from portbench.run import main
    from stereomatch_tpu_torch import serving

    real = serving.compile_mst_video_server
    monkeypatch.setattr(serving, "compile_mst_video_server",
                        lambda *a, **k: real(*a, **dict(k, reuse_forest=True)))
    assert main(["--workload", CELL, "--seed", "37", "--seconds", "1", "--trace", "0",
                 "--device", "cpu", "--rehearse"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is False
    assert out["check"]["gap_share"]["value"] > out["check"]["gap_share"]["limit"]


@pytest.mark.parametrize("server,traffic", [({"reuse_forest": True}, "video_stream"),
                                            ({}, "independent_pairs")])
def test_the_system_refuses_what_is_not_this_deployment(server, traffic):
    from portbench.traffic import load_mix

    cfgmod = load_module(ROOT / "portbench" / "configs" / f"{CONFIG}.py", "rebuild_cfg_test")
    spec = _spec()
    spec.update(spec["rehearsal"])
    spec["server"] = dict(spec["server"], **server)
    with pytest.raises(ValueError, match="reuse_forest"):
        cfgmod.System(spec, load_mix(traffic), "cpu")


def test_reference_loads_no_jax_and_nothing_of_the_program():
    code = (
        "import json, sys\n"
        "from portbench.traffic import load_mix, make_traffic\n"
        "from portbench.reference.video_rebuild import mst_video_rebuild_group\n"
        f"spec = json.load(open('portbench/configs/{CONFIG}.json'))\n"
        "spec.update(spec['rehearsal'])\n"
        "sc = make_traffic(load_mix('video_stream'), 48, 64, 16, 1, 'cpu').scenes[:2]\n"
        "mst_video_rebuild_group([(s.left, s.right) for s in sc], [3, 4],"
        " [(sc[0].disp_left,) * 2], spec, 0.6, lower=True, device='cpu')\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    mods = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "stereomatch_tpu", "stereomatch_tpu_torch"}


# ---- the readers on a hand-made trace ----

def _op(name, s, e=None):
    return (name, float(s), float(s if e is None else e))


def _trace(temporal: bool = True) -> Trace:
    """K T T on a 0-150 us timeline. The keyframe's forest (10-20) holds
    syncs at 12 and 15 and the idle (10, 20); inside the temporal spans
    the forests hold syncs at 63 (a round), 75 and 125, and idle 61-66,
    72-80 and 121-129 (21 us); a sync at 55 lies in a temporal span
    outside its forests, one at 99 in a submit outside its temporal span."""
    spans = [
        _op("sm.server.submit", 0, 40), _op("sm.forest", 10, 20),
        _op("sm.server.submit", 50, 100), _op("sm.server.temporal", 52, 98),
        _op("sm.forest", 60, 70), _op("sm.forest.round", 62, 64), _op("sm.forest", 70, 80),
        _op("sm.server.submit", 110, 150), _op("sm.server.temporal", 112, 148),
        _op("sm.forest", 120, 130),
    ]
    if not temporal:
        spans = [x for x in spans if x[0] != "sm.server.temporal"]
    syncs = [_op("cudaStreamSynchronize", t) for t in (12, 15, 55, 63, 75, 99, 125)]
    busy = [(0, 10), (30, 61), (66, 72), (90, 121), (129, 150)]
    return Trace(frames=3, keys=1, window_s=1.5e-4,
                 kernels=[("k", float(s), float(e)) for s, e in busy],
                 cpu_ops=spans + syncs + [_op("cudaLaunchKernel", 5)], syncs=7,
                 t0_us=0.0, t1_us=150.0)


def _read(name: str, trace):
    mod = load_module(ROOT / "portbench" / "metrics" / f"{name}.py", f"reader_{name}")
    return mod.read(SimpleNamespace(trace=trace, spec={}, mix={"stateful": True}, frames=[]))


def test_readers_count_only_inside_the_temporal_spans():
    tr = _trace()
    assert _read("forest.temporal_syncs_per_frame", tr) == 3 / 2
    assert _read("forest.temporal_idle_ms_per_frame", tr) == 21 / 2 / 1e3
    assert _read("server.temporal_submit_ms", tr) == pytest.approx((46 + 36) / 2 / 1e3)
    # the layer's own readers count the keyframe's forest too, over 3 frames
    assert _read("forest.syncs_per_frame", tr) == 5 / 3
    assert _read("forest.idle_ms_per_frame", tr) == pytest.approx((10 + 21) / 3 / 1e3)


@pytest.mark.parametrize("name", READERS)
def test_readers_without_the_temporal_span_read_nothing(benchmark, name):
    """A program that opens no temporal span (the parent's, or a keyframe-
    only mix), and no trace at all."""
    assert _read(name, _trace(temporal=False)) is None and _read(name, None) is None
    entry = {m["name"]: m for m in benchmark["per_layer"]}[name]
    assert entry["workloads"] == [CELL] and entry["moves"] == "frames_per_s"
