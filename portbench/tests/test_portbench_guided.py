"""The cell `mst_pairs_guided`: the pair server on its default guided-filtered
volume, with the reference `portbench/reference/guided.py` and the guided
filter's yardstick (`portbench/guided_yardstick.py`).

At the rehearsal size on the CPU: the run prints a well-formed line, the
control fails while the program passes, a broken path comes out not
correct (half of the frame left out, an answer altered, the guided filter
skipped), and the reference loads nothing of the program. On hand-made
traces: the rank matcher's device time, and None where launch calls and
kernels do not pair one to one."""

import json
from types import SimpleNamespace

import pytest

from conftest import ROOT, last_line, run_harness
from portbench.guided_yardstick import guided_bytes, roofline_pct, span_kernel_s
from portbench.tracing import Trace
from portbench.yardstick import bound_s

CELL, CONFIG = "mst_pairs_guided", "mst_2048x1536_d100_guided"


def _spec() -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{CONFIG}.json").read_text())


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_prints_a_well_formed_line(benchmark, trace):
    out = last_line(run_harness("--workload", CELL, "--seed", str(2**31 + 17), "--seconds", "1.5",
                                "--trace", str(trace), "--device", "cpu", "--rehearse"))
    assert list(out)[-1] == "check" and set(out["check"]) == {"gap_share", "gt_worst_pct"}
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if trace:
        # the CPU trace holds no launch: counts and idle only, no roofline
        assert set(out["metrics"]) == {"volume.guided_launches_per_frame",
                                       "volume.guided_idle_ms_per_frame"}
        assert out["metrics"]["volume.guided_launches_per_frame"]["value"] == 0.0
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


def _run(capsys) -> dict:
    from portbench.run import main

    assert main(["--workload", CELL, "--seed", "23", "--seconds", "1", "--trace", "0",
                 "--device", "cpu", "--rehearse"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
def test_a_broken_path_is_not_correct(request, capsys, fault):
    from portbench.faults import plant

    request.addfinalizer(plant(_spec(), fault))
    assert _run(capsys)["correct"] is False


def test_a_skipped_guided_filter_is_not_correct(monkeypatch, capsys):
    """The program serves the raw volume where the guided one is due."""
    from stereomatch_tpu_torch.apps import stereo_yin

    monkeypatch.setattr(stereo_yin, "guided_filter_volume", lambda guide, vol, *a, **k: vol)
    out = _run(capsys)
    assert out["correct"] is False
    assert out["check"]["gap_share"]["value"] > out["check"]["gap_share"]["limit"]


def test_the_system_refuses_constants_the_program_does_not_use():
    from portbench.run import load_module
    from portbench.traffic import load_mix

    cfgmod = load_module(ROOT / "portbench" / "configs" / f"{CONFIG}.py", "guided_cfg_test")
    spec = _spec()
    spec.update(spec["rehearsal"])
    spec["guided"] = dict(spec["guided"], eps=650.25)
    with pytest.raises(ValueError, match="eps"):
        cfgmod.System(spec, load_mix("independent_pairs"), "cpu")


def test_reference_loads_no_jax_and_nothing_of_the_program():
    import subprocess
    import sys

    code = (
        "import json, sys\n"
        "from portbench.run import load_module\n"
        "from portbench.traffic import load_mix, make_traffic\n"
        f"spec = json.load(open('portbench/configs/{CONFIG}.json'))\n"
        "spec.update(spec['rehearsal'])\n"
        f"m = load_module(__import__('pathlib').Path('portbench/configs/{CONFIG}.py'), 'c')\n"
        "t = make_traffic(load_mix('independent_pairs'), 48, 64, 16, 1, 'cpu')\n"
        "sample = [{'i': 0, 'key_seed': 3}]\n"
        "m.reference(sample, t, spec, 'cpu')\n"
        "m.reference(sample, t, spec, 'cpu', lower=True)\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    mods = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "stereomatch_tpu", "stereomatch_tpu_torch"}


# ---- the yardstick on hand-made traces ----

def _op(name, s, e=None):
    return (name, float(s), float(s if e is None else e))


def _trace(launch_at, kernels, spans) -> Trace:
    """Two frames; launch calls at `launch_at` (us, host), `kernels` as
    (start, end) on the device, program spans as (name, start, end)."""
    ops = [_op("cudaLaunchKernel", t) for t in launch_at] + [_op(n, s, e) for n, s, e in spans]
    ops.append(_op("aten::add", 0, 1))
    return Trace(frames=2, keys=2, window_s=1e-3,
                 kernels=[(f"k{i}", float(s), float(e)) for i, (s, e) in enumerate(kernels)],
                 copies=[("Memcpy HtoD", 0.0, 100.0)], cpu_ops=ops, t0_us=0.0, t1_us=400.0)


SPANS = [("sm.server.submit", 0, 100), ("sm.volume", 5, 60), ("sm.volume.guided", 10, 50),
         ("sm.server.submit", 200, 300), ("sm.volume", 205, 260),
         ("sm.volume.guided", 210, 250)]
# launches by host start: 6 (sm.volume), 12, 30 (guided), 70 (submit), 211 (guided), 255
LAUNCH_AT = [255, 12, 6, 211, 70, 30]
# kernels by device start: the 2nd, 3rd and 5th are the guided filter's
KERNELS = [(310, 330), (20, 25), (8, 10), (30, 45), (100, 190), (220, 300)]


def test_rank_matcher_sums_the_kernels_of_launches_in_the_span():
    tr = _trace(LAUNCH_AT, KERNELS, SPANS)
    assert span_kernel_s(tr) == pytest.approx((5 + 15 + 80) / 1e6)
    assert span_kernel_s(tr, "sm.volume") == pytest.approx((2 + 20) / 1e6)


def test_roofline_is_the_bytes_bound_over_the_matched_time():
    tr = _trace(LAUNCH_AT, KERNELS, SPANS)
    spec = {"rows": 1536, "cols": 2048, "max_disp": 100, "guided": {}}
    want = 100.0 * bound_s(2 * guided_bytes(1536, 2048, 100)) / (100 / 1e6)
    assert roofline_pct(SimpleNamespace(trace=tr, spec=spec)) == pytest.approx(want)
    # 5.06 GB a frame, 1.51 ms at 3.35 TB/s
    assert guided_bytes(1536, 2048, 100) == 2 * 201 * 1536 * 2048 * 4
    assert bound_s(guided_bytes(1536, 2048, 100)) * 1e3 == pytest.approx(1.5099, abs=1e-4)


def test_rank_matcher_reads_nothing_where_counts_differ_or_the_span_is_absent():
    assert span_kernel_s(_trace(LAUNCH_AT, KERNELS[:-1], SPANS)) is None
    assert span_kernel_s(_trace(LAUNCH_AT + [399], KERNELS, SPANS)) is None
    raw = [s for s in SPANS if s[0] != "sm.volume.guided"]
    assert span_kernel_s(_trace(LAUNCH_AT, KERNELS, raw)) is None
    assert span_kernel_s(None) is None
    spec = {"rows": 1536, "cols": 2048, "max_disp": 100, "guided": {}}
    assert roofline_pct(SimpleNamespace(trace=_trace(LAUNCH_AT, KERNELS[:-1], SPANS),
                                        spec=spec)) is None
    assert roofline_pct(SimpleNamespace(trace=None, spec=spec)) is None
