"""The SGBM-seeded 3DMST frame at 2048x1536 with 100 disparities on the raw
adgrad volume, served by the program's streaming servers.

A stateless mix drives `compile_sgbm_mst_server`: each frame builds its
cost volumes, its SGBM seed (K1), both device forests and refines both
views (K2, K2a). A stateful mix drives `compile_mst_video_server` with
`reuse_forest`: a keyframe every `reseed_every` frames does all of that,
the frames between refine the previous maps on the keyframe's forests.
Frames arrive as host BGR arrays; the maps come back as host arrays.
"""

from __future__ import annotations

import numpy as np


class System:
    """submit(frame index, left, right, key seed) -> ticket; collect(ticket)
    -> (left map, right map), both before the LR check."""

    def __init__(self, spec: dict, mix: dict, device):
        from stereomatch_tpu_torch.config import production_mst_config
        from stereomatch_tpu_torch.serving import compile_mst_video_server, compile_sgbm_mst_server

        m, srv = spec["mst"], spec["server"]
        self.spec, self.mix = spec, mix
        cfg = production_mst_config(
            spec["max_disp"], forest_backend="device", gamma=m["gamma"], c=m["c"],
            min_cc_size=m["min_cc_size"], median_prefilter=m["median_prefilter"],
            max_log_range=m["max_log_range"], carry_iters=m["carry_iters"],
            normalize_aggregation=m["normalize_aggregation"], volume_dtype=m["volume_dtype"])
        common = dict(cfg=cfg, fine_iterations=m["fine_iterations"],
                      refine_start=m["refine_start"], max_neighbors=m["max_neighbors"],
                      right_seed=m["right_seed"], capacity=srv["capacity"], device=device,
                      volume_guided=spec["volume"] == "adgrad_guided")
        rows, cols = spec["rows"], spec["cols"]
        if mix["stateful"]:
            self.server = compile_mst_video_server(
                rows, cols, temporal_iterations=m["temporal_iterations"],
                temporal_refine_start=m["temporal_refine_start"],
                reseed_every=srv["reseed_every"], reuse_forest=srv["reuse_forest"],
                scene_cut_ratio=srv["scene_cut_ratio"], **common)
        else:
            self.server = compile_sgbm_mst_server(rows, cols, **common)
        self.is_key: dict[int, bool] = {}
        self.depth = srv["capacity"]  # frames in flight in the closed loop
        self._every = int(srv["reseed_every"]) if mix["stateful"] else 1
        self._since_reset = 0

    def submit(self, i: int, left: np.ndarray, right: np.ndarray, key_seed: int) -> int:
        t = self.server.submit_pair(left, right, seed=key_seed)
        # the video server's cadence: a keyframe after reset() and then every
        # `reseed_every` frames. A scene cut serves a temporal frame again as
        # a keyframe when it is collected; it stays a temporal frame here, as
        # the reference's video group replays the cut itself
        self.is_key[i] = self._since_reset % self._every == 0
        self._since_reset += 1
        return t

    def collect(self, ticket: int):
        return self.server.collect(ticket)

    def reset(self) -> None:
        """The next frame starts the stream afresh (a keyframe)."""
        self._since_reset = 0
        if self.mix["stateful"]:
            self.server.reset()

    def failures(self) -> int:
        return int(self.server.failures)

    def counters(self) -> dict:
        return {"scene_cuts": int(getattr(self.server, "scene_cuts", 0))}


def score(maps, scene, spec: dict, eval_mask, threshold: float = 2.0) -> tuple[int, int]:
    """(bad, scored) pixels of one frame's LR-checked left map."""
    from portbench.yardstick import bad_counts, lr_valid

    dl, dr = maps
    valid = lr_valid(dl, dr, float(spec["max_disp"]))
    return bad_counts(dl, valid, scene.disp_left, eval_mask, threshold)


def check_sample(frames: list, traffic) -> list:
    """The window's frames to compare, drawn from the seed: `check_frames`
    of a stateless mix, or one whole keyframe group of a stateful mix (the
    keyframe recomputed from its inputs alone, each temporal frame from
    its inputs and the maps delivered for the frame before it)."""
    k = int(traffic.mix["check_frames"])
    if not traffic.mix["stateful"]:
        return traffic.sample(frames, k)
    starts = [j for j, f in enumerate(frames) if f["is_key"] and j + k <= len(frames)
              and not any(g["is_key"] for g in frames[j + 1:j + k])]
    if not starts:
        raise RuntimeError("no whole keyframe group finished in the window")
    j = traffic.sample(starts, 1)[0]
    return frames[j:j + k]


def reference(sample: list, traffic, spec: dict, device, lower: bool = False) -> list:
    """The reference's maps of the sampled frames (`lower`: the control)."""
    from portbench.reference.frames import mst_pair, mst_video_group

    scenes = [traffic.scene(f["i"]) for f in sample]
    if traffic.mix["stateful"]:
        return mst_video_group([(s.left, s.right) for s in scenes],
                               [f["key_seed"] for f in sample], [f["maps"] for f in sample],
                               spec, spec["server"]["scene_cut_ratio"], lower=lower,
                               device=device)
    return [mst_pair(s.left, s.right, f["key_seed"], spec, lower=lower, device=device)
            for s, f in zip(scenes, sample)]


def compare(got: list, want: list, spec: dict) -> dict:
    """The share of pixels where two maps differ by more than `gap_px`,
    worst frame and view."""
    gap = float(spec["check"]["gap_px"])
    worst = 0.0
    for g_maps, w_maps in zip(got, want, strict=True):
        for g, w in zip(g_maps, w_maps, strict=True):
            if g.shape != w.shape or not np.isfinite(g).all():
                return {"gap_share": 1.0}
            worst = max(worst, float(np.mean(np.abs(g - w) > gap)))
    return {"gap_share": worst}


def limits(spec: dict) -> dict:
    return {"gap_share": float(spec["check"]["gap_share_limit"])}
