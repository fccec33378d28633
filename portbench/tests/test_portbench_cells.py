"""Every cell end to end on the CPU at its configuration's rehearsal size,
the harness's guards, and a cell added as new files only.

`--device cpu --rehearse` skips the harness's look for a card; everything
else is the run the benchmark makes: render, build, warm-up, the window,
the traced frames, scoring, the check against the reference and the last
line."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, last_line, run_harness

CELLS = ["mst_video_stream", "mst_independent_pairs", "sgbm_flir_pairs"]


def _cell_metrics(bench, cell, kind):
    return {m["name"] for m in bench[kind] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsal_prints_a_well_formed_line(benchmark, cell, trace):
    out = last_line(run_harness("--workload", cell, "--seed", str(2**31 + 5), "--seconds", "1.5",
                                "--trace", str(trace), "--device", "cpu", "--rehearse"))
    assert list(out)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if trace:
        # the CPU trace holds no device event: only the server's latencies
        assert set(out["metrics"]) <= _cell_metrics(benchmark, cell, "per_layer")
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
    else:
        assert set(out["metrics"]) == _cell_metrics(benchmark, cell, "end_to_end")
        assert out["metrics"]["frames_per_s"]["value"] > 0


def test_same_seed_same_frames():
    from portbench.traffic import load_mix, make_traffic

    mix = load_mix("independent_pairs")
    a = make_traffic(mix, 48, 64, 16, 123, "cpu")
    b = make_traffic(mix, 48, 64, 16, 123, "cpu")
    c = make_traffic(mix, 48, 64, 16, 124, "cpu")
    assert [a.scene_index(i) for i in range(20)] == [b.scene_index(i) for i in range(20)]
    assert [a.key_seed(i) for i in range(5)] == [b.key_seed(i) for i in range(5)]
    assert [a.key_seed(i) for i in range(5)] != [c.key_seed(i) for i in range(5)]
    assert all(0 <= a.key_seed(i) < 2**31 for i in range(-3, 50))
    # every seed serves the same scenes, in another order
    assert sorted({c.scene_index(i) for i in range(8)}) == list(range(8))


def test_no_card_no_result():
    proc = run_harness("--workload", "sgbm_flir_pairs", "--seed", "1", "--seconds", "1",
                       "--trace", "0")
    if proc.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert proc.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "sgbm_flir_pairs",
                           "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu",
                           "--rehearse"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _top_level_modules_after(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                           "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_harness_process_loads_no_jax():
    mods = _top_level_modules_after(
        "from portbench.run import main\n"
        "main(['--workload', 'mst_independent_pairs', '--seed', '9', '--seconds', '0.5',"
        " '--trace', '1', '--device', 'cpu', '--rehearse'])")
    assert "stereomatch_tpu_torch" in mods and "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "stereomatch_tpu"}


def test_reference_loads_no_jax_and_nothing_of_the_program():
    mods = _top_level_modules_after(
        "import json\n"
        "from portbench.traffic import load_mix, make_traffic\n"
        "from portbench.reference.frames import mst_pair, mst_video_group, sgbm_flir\n"
        "spec = json.load(open('portbench/configs/mst_2048x1536_d100_raw.json'))\n"
        "spec.update(spec['rehearsal'])\n"
        "sc = make_traffic(load_mix('video_stream'), 48, 64, 16, 1, 'cpu').scenes[:2]\n"
        "mst_pair(sc[0].left, sc[0].right, 3, spec, device='cpu')\n"
        "g = mst_video_group([(s.left, s.right) for s in sc], [3, 4], [(sc[0].disp_left,) * 2],"
        " spec, 0.6, lower=True, device='cpu')\n"
        "s2 = json.load(open('portbench/configs/sgbm_flir_2048x1536_d256.json'))\n"
        "sgbm_flir(sc[0].left[..., ::-1], sc[0].right[..., ::-1], s2, device='cpu',"
        " band_threshold_bytes=0)")
    assert not mods & {"jax", "jaxlib", "flax", "stereomatch_tpu", "stereomatch_tpu_torch"}


def test_forbidden_names_compare_whole():
    from portbench.run import forbidden_modules

    fake = {"jax.numpy": object(), "stereomatch_tpu_torch.ops": object()}
    sys.modules.update(fake)
    try:
        found = forbidden_modules()
    finally:
        for k in fake:
            del sys.modules[k]
    assert "jax" in found and "stereomatch_tpu_torch" not in found


def test_a_cell_is_added_as_new_files_only(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and the cell that
    uses them, added to a copy of the benchmark as new files and entries;
    no file that is there changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfgs = tmp_path / "portbench" / "configs"
    spec = json.loads((ROOT / "portbench/configs/sgbm_flir_2048x1536_d256.json").read_text())
    spec.update(name="sgbm_tiny", rows=96, cols=160, max_disp=64,
                sgbm=dict(spec["sgbm"], num_disp=64, min_disp=0),
                rehearsal={"rows": 96, "cols": 160, "max_disp": 64,
                           "check": spec["rehearsal"]["check"]})
    (cfgs / "sgbm_tiny.json").write_text(json.dumps(spec))
    (cfgs / "sgbm_tiny.py").write_text((cfgs / "sgbm_flir_2048x1536_d256.py").read_text())
    (tmp_path / "portbench/traffic/tiny_pairs.json").write_text(json.dumps(
        {"scenes": "independent", "count": 2, "order": "cycle", "scene_seed": 4, "n_discs": 2,
         "n_waves": 8, "stateful": False, "warm_frames": 1, "trace_frames": 1,
         "check_frames": 1}))
    (tmp_path / "portbench/metrics/tiny.frames_seen.py").write_text(
        "def read(run):\n    return float(len(run.frames))\n")
    bench["configs"].append({"name": "sgbm_tiny", "source": "https://example.org/tiny",
                             "file": "portbench/configs/sgbm_tiny.json", "reduced": [],
                             "why": "a throwaway cell"})
    bench["workloads"].append({"name": "tiny", "config": "sgbm_tiny", "traffic": "tiny_pairs",
                               "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "tiny.frames_seen", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "server", "moves": "frames_per_s",
                               "workloads": ["tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace in ("0", "1"):
        out = last_line(run_harness("--workload", "tiny", "--seed", "3", "--seconds", "1",
                                    "--trace", trace, "--device", "cpu", "--rehearse",
                                    cwd=tmp_path))
        assert out["correct"] is True
    assert out["metrics"]["tiny.frames_seen"]["value"] >= 1
    after = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
             if p.is_file() and p in before}
    assert after == before
