"""What decides `correct`: the control (the reference in the precision
below the configured one) fails each cell's comparison while the program
passes it, and a run whose timed path is broken underneath comes out not
correct, once for each fault a cell can have: a step that returns its
state unchanged (the video cell's temporal frames), half of the frame left
out, an answer altered where it is produced (`portbench/faults.py`). The
cells run on one card, so no exchange between cards exists to leave out.
All at the rehearsal size on the CPU; on the card at full size
`portbench.control --fault <name>` reads the same."""

import json

import pytest
import torch

from conftest import ROOT, run_harness
from portbench.faults import MST_FAULTS, SGBM_FAULTS

CELLS = ["mst_video_stream", "mst_independent_pairs", "sgbm_flir_pairs"]
MST, SGBM = "mst_2048x1536_d100_raw", "sgbm_flir_2048x1536_d256"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes(cell):
    proc = run_harness("--workload", cell, "--seeds", "4", "5", "--control-seeds", "2",
                       "--seconds", "1", "--device", "cpu", "--rehearse",
                       module="portbench.control")
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    limits = summary["limits"]
    assert all(summary["largest_sound"][k] <= v for k, v in limits.items())
    # the control has to fail one of the cell's numbers: the comparison with
    # the reference (it stays as close to exact ground truth as the program)
    assert any(summary["smallest_control"][k] > v for k, v in limits.items())


def _run(capsys, cell):
    from portbench.run import main

    assert main(["--workload", cell, "--seed", "17", "--seconds", "1", "--trace", "0",
                 "--device", "cpu", "--rehearse"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _planted(request, config, fault):
    from portbench.faults import plant

    spec = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    request.addfinalizer(plant(spec, fault))


@pytest.mark.parametrize("fault", MST_FAULTS)
def test_video_cell_catches_a_broken_path(request, capsys, fault):
    _planted(request, MST, fault)
    assert _run(capsys, "mst_video_stream")["correct"] is False


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
def test_pairs_cell_catches_a_broken_path(request, capsys, fault):
    _planted(request, MST, fault)
    assert _run(capsys, "mst_independent_pairs")["correct"] is False


@pytest.mark.parametrize("fault", SGBM_FAULTS)
def test_sgbm_cell_catches_a_broken_path(request, capsys, fault):
    _planted(request, SGBM, fault)
    assert _run(capsys, "sgbm_flir_pairs")["correct"] is False


@pytest.mark.parametrize("cell", ["mst_independent_pairs", "sgbm_flir_pairs"])
def test_exact_ground_truth_alone_catches_an_altered_answer(cell):
    """The floor against exact ground truth holds without the reference: a
    map off by a pixel everywhere fails it on its own. One cell of each
    configuration, which sets the floor's limit (the video cell's altered
    frames trip its scene-cut detector at this size, so no whole keyframe
    group is left to sample)."""
    proc = run_harness("--workload", cell, "--seeds", "6", "--control-seeds", "0",
                       "--seconds", "1", "--device", "cpu", "--rehearse",
                       "--fault", "answer_altered", module="portbench.control")
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["largest_sound"]["gt_worst_pct"] > summary["limits"]["gt_worst_pct"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the program on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cuda, cell):
    proc = run_harness("--workload", cell, "--seed", "2147483653", "--seconds", "3",
                       "--trace", "1", timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
