"""The port's utils (stereomatch_tpu_torch/utils/): StageTimer and
timing_stat as tests/test_utils.py tests the JAX package's, profile_trace's
trace file, and the checkpoint and debug savers from tensors, whose files
equal the JAX package's for the same arrays."""

import glob
import json
import os
import pathlib
from collections import namedtuple

import numpy as np
import pytest
import torch

from stereomatch_tpu import utils as jutils
from stereomatch_tpu_torch.utils import (
    StageTimer, load_state, profile_trace, save_cost_slice, save_state, save_support_weights,
    save_tree_weights, timing_stat,
)


def test_timing_stat_mean_std():
    mean, std = timing_stat([2.0, 4.0, 6.0])
    assert mean == pytest.approx(4.0)
    assert std == pytest.approx(np.std([2.0, 4.0, 6.0]))
    assert timing_stat([]) == (0.0, 0.0)
    assert timing_stat([1.5, 7.25, 3.0]) == jutils.timing_stat([1.5, 7.25, 3.0])


def test_stage_timer_accumulates_and_reports(capsys):
    t = StageTimer(verbose=True)
    x = torch.ones((8, 8))
    with t.stage("a", result=x):
        y = x + 1
    out = t.time("b", lambda v: (v * 2, {"k": [v]}), y)
    assert out[0].max().item() == 4.0
    with t.stage("a"):
        pass
    assert set(t.stages) == {"a", "b"} and len(t.stages["a"]) == 2
    rep = t.report()
    assert "a:" in rep and "b:" in rep and "ms" in rep and "(n=2)" in rep
    assert "b: " in capsys.readouterr().out


def test_profile_trace_writes_a_trace(tmp_path):
    """profile_trace writes a Chrome trace of the wrapped region into the
    directory, with the region's operators in it."""
    logdir = str(tmp_path / "trace")
    with profile_trace(logdir):
        torch.sum(torch.ones((64, 64)) * 2.0)
    found = glob.glob(os.path.join(logdir, "*.json"))
    assert len(found) == 1, found
    with open(found[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mul" in str(e.get("name")) for e in events)


def test_checkpoint_round_trip_from_tensors(tmp_path, rng):
    a = rng.random((5, 6)).astype(np.float32)
    labels = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    path = str(tmp_path / "state.npz")
    save_state(path, a=torch.from_numpy(a), labels=labels, half=torch.ones(3, dtype=torch.bfloat16),
               host=np.float64(2.5))
    got = load_state(path)
    np.testing.assert_array_equal(got["a"], a)
    np.testing.assert_array_equal(got["labels"], labels.numpy())
    assert got["half"].dtype == np.float32 and (got["half"] == 1).all()
    assert float(got["host"]) == 2.5
    want = jutils.load_state(path)
    assert sorted(want) == sorted(got)
    jpath = str(tmp_path / "jax.npz")
    jutils.save_state(jpath, a=a, labels=labels.numpy())
    for k, v in load_state(jpath).items():
        np.testing.assert_array_equal(v, got[k])


def test_debug_savers_from_tensors_equal_jax(tmp_path, rng):
    vol = rng.random((9, 13, 4)).astype(np.float32)
    fa = namedtuple("F", "pixel_of_node w_exp")
    perm = rng.permutation(9 * 13)
    w_exp = rng.random(9 * 13).astype(np.float32)
    alpha = rng.random((9, 13, 3)).astype(np.float32)
    cases = (
        (save_cost_slice, jutils.save_cost_slice, (torch.from_numpy(vol), 2), (vol, 2)),
        (save_tree_weights, jutils.save_tree_weights,
         (fa(torch.from_numpy(perm), torch.from_numpy(w_exp)), 9, 13), (fa(perm, w_exp), 9, 13)),
        (save_support_weights, jutils.save_support_weights, (torch.from_numpy(alpha), 1),
         (alpha, 1)),
    )
    for i, (ours, theirs, t_args, j_args) in enumerate(cases):
        a, b = tmp_path / f"t{i}.png", tmp_path / f"j{i}.png"
        ours(str(a), *t_args)
        theirs(str(b), *j_args)
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
