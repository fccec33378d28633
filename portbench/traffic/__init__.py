"""Traffic: one general generator over the mixes in this folder.

A mix is a JSON file of parameters, found by its name in BENCHMARK.json:

- `scenes`: "independent" (`count` unrelated scenes, each from its own
  seed) or "sequence" (one coherent sequence of `count` frames whose discs
  move by `drift` px a frame);
- `order`: "cycle" (0, 1, .., count-1, 0, ..) or "pingpong" (0 .. count-1
  .. 1, 0, ..), the scene of each frame of the closed loop;
- `scene_seed`: the scenes are the same for every run's seed, which draws
  only where in the order the loop starts, the per-frame RNG keys and the
  frames the check samples: so every run does the same work, in another
  order;
- `n_discs`, `n_waves`: the scene's discs and the sinusoids of a texture;
- `stateful`: whether the system carries state from frame to frame;
- `warm_frames`, `trace_frames`, `check_frames`: frames served to warm up,
  traced, and compared with the reference.

The configuration gives the frame's rows, columns and disparity range.
The same seed gives the same frames in the same order with the same keys.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .render import Scene, render_scene, render_sequence, scene_eval_mask

__all__ = ["Traffic", "load_mix", "make_traffic", "Scene", "scene_eval_mask"]

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    with open(HERE / f"{name}.json") as f:
        return json.load(f)


def _entropy(seed: int, *more: int) -> list[int]:
    """numpy seed material from the run's seed (any integer) and indices."""
    return [int(seed) % (1 << 63), *more]


@dataclass
class Traffic:
    mix: dict
    seed: int
    scenes: list  # of Scene, host arrays

    def _period(self) -> int:
        n = len(self.scenes)
        if self.mix["order"] == "cycle" or n == 1:
            return n
        if self.mix["order"] == "pingpong":
            return 2 * n - 2
        raise ValueError(f"unknown order {self.mix['order']!r}")

    def scene_index(self, i: int) -> int:
        """The scene of frame i: the order, entered at an offset drawn from
        the seed."""
        n, period = len(self.scenes), self._period()
        offset = int(np.random.default_rng(_entropy(self.seed, 3)).integers(period))
        p = (i + offset) % period
        return p if p < n else period - p

    def scene(self, i: int) -> Scene:
        return self.scenes[self.scene_index(i)]

    def key_seed(self, i: int) -> int:
        """The int32 RNG seed of frame i (the program keys a frame by it)."""
        ss = np.random.SeedSequence(_entropy(self.seed, 1, i % (1 << 62)))
        return int(ss.generate_state(1)[0]) & 0x7FFFFFFF

    def sample(self, candidates: list, k: int, salt: int = 0) -> list:
        """k of the candidates, drawn from the seed, in their order."""
        if len(candidates) <= k:
            return list(candidates)
        rng = np.random.default_rng(_entropy(self.seed, 2, salt))
        pick = sorted(rng.choice(len(candidates), size=k, replace=False).tolist())
        return [candidates[j] for j in pick]


def make_traffic(mix: dict, rows: int, cols: int, max_disp: int, seed: int,
                 device) -> Traffic:
    n = int(mix["count"])
    shape = dict(n_discs=int(mix["n_discs"]), n_waves=int(mix["n_waves"]), device=device)
    base = int(mix["scene_seed"])
    if mix["scenes"] == "independent":
        scenes = [render_scene([base, i], rows, cols, max_disp, **shape) for i in range(n)]
    elif mix["scenes"] == "sequence":
        scenes = render_sequence([base], n, rows, cols, max_disp, drift=float(mix["drift"]),
                                 **shape)
    else:
        raise ValueError(f"unknown scenes {mix['scenes']!r}")
    return Traffic(mix, int(seed), scenes)
