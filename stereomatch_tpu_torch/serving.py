"""Streaming servers for the SGBM-seeded 3DMST frame and the video stream
(port of `stereomatch_tpu/serving.py`: `StereoStreamServer`,
`compile_sgbm_mst_server`, `VideoStreamServer`, `compile_mst_video_server`).

`submit()` uploads a frame's inputs and enqueues the frame on the current
CUDA stream, then returns a ticket; `collect()` copies that frame's
outputs to the host, which is where the host waits for the device. With
`capacity` >= 2 frame N+1 is enqueued while frame N runs; submitting
beyond `capacity` first collects the oldest frame (backpressure), which
bounds device memory to `capacity` frames. A frame that builds a forest
still waits on the host inside `submit` wherever the build checks a loop
for convergence; a temporal frame that refines on a chained forest
(`reuse_forest`) enqueues without a host sync.

Not ported, and listed under "Do not port" in ROADMAP.md: the staged
chain (`staged=True`) and the executable cache (`cache_dir`).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import numpy as np
import torch

from .config import MSTConfig, SGBMConfig
from . import random as trandom
from .utils.timing import span

__all__ = [
    "StereoStreamServer",
    "VideoStreamServer",
    "compile_sgbm_mst_server",
    "compile_mst_video_server",
]

_DO_NOT_PORT = "ROADMAP.md, 'Do not port'"


def _reject_unported(staged: bool, cache_dir: str | None) -> None:
    if staged:
        raise NotImplementedError(
            "staged=True is not ported: in eager PyTorch the staged and the fused frame "
            f"are the same launches ({_DO_NOT_PORT})")
    if cache_dir is not None:
        raise NotImplementedError(
            "cache_dir is not ported: the port's only compiled artifacts are its kernels, "
            f"cached in build/torch_ext/ ({_DO_NOT_PORT})")


def _to_host(outputs) -> tuple:
    """numpy copies of a frame's output tensors. The .cpu() copy is where
    the host waits for the device, and where a failed frame raises."""
    return tuple(t.cpu().numpy() for t in outputs)


def _host_snapshot(a):
    """Host view of one frame argument (array, tensor or dict of them)."""
    if isinstance(a, dict):
        return {k: _host_snapshot(v) for k, v in a.items()}
    return a.cpu() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclass
class _Pending:
    ticket: int
    outputs: Any
    replay: Callable[[], Any] | None = None  # re-execution from host inputs
    stat: Any = None  # device scalar: the frame's LR-valid fraction
    is_key: bool = False  # video server: keyframe or temporal frame


class StereoStreamServer:
    """Asynchronous executor over one frame function on one device.

    `pipeline(*device_args)` returns a tuple of device tensors;
    `collect(ticket)` returns them as numpy arrays.

    Failure replay (`retries` > 0): the server keeps a host view of each
    in-flight frame's inputs (the caller must not overwrite a submitted
    frame's arrays before it is collected). When the `.cpu()` copy of an
    output raises, the frame is uploaded and run again, up to `retries`
    times, `retry_backoff_s` apart; `failures` counts the attempts. A
    failure the dispatch itself raises is replayed at once. Replay in the
    same process covers only errors the CUDA context survives: a sticky
    error, an illegal address for example, leaves the context unusable and
    every later call raises too."""

    def __init__(
        self,
        pipeline: Callable[..., Any],
        device: torch.device | str,
        capacity: int = 2,
        retries: int = 0,
        retry_backoff_s: float = 0.0,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.pipeline = pipeline
        self.device = torch.device(device)
        self.capacity = capacity
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        self.failures = 0
        # the video server's scene-cut replay needs a replay path even
        # with retries=0
        self._always_replay = False
        self._queue: deque[_Pending] = deque()
        self._next = 0
        self._done: dict[int, Any] = {}

    def _up(self, a):
        if isinstance(a, dict):  # a chained forest
            return {k: self._up(v) for k, v in a.items()}
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    def submit(
        self,
        *frame_args,
        _pipeline: Callable[..., Any] | None = None,
        _replay_args: tuple | None = None,
        _post: Callable[[Any], Any] | None = None,
        _replay_post: Callable[[Any], Any] | None = None,
    ) -> int:
        """Enqueue one frame; returns its ticket. `_pipeline` overrides the
        frame function; `_post` transforms its output before it is queued.
        `_replay_args` re-route a replay through `self.pipeline` with other
        arguments, and `_replay_post` transforms that replay's output."""
        if len(self._queue) >= self.capacity:
            self._finish(self._queue.popleft())
        replay = None
        if self.retries or (self._always_replay and _replay_args is not None):
            src = frame_args if _replay_args is None else _replay_args
            target = (_pipeline or self.pipeline) if _replay_args is None else self.pipeline
            rp = _replay_post if _replay_args is not None else (_replay_post or _post)
            host = tuple(_host_snapshot(a) for a in src)

            def replay(host=host, target=target, rp=rp):
                out = target(*[self._up(a) for a in host])
                return rp(out) if rp else out

        try:
            out = (_pipeline or self.pipeline)(*[self._up(a) for a in frame_args])
            if _post:
                out = _post(out)
        except RuntimeError:
            if replay is None:
                raise
            self.failures += 1
            out = replay()
        ticket = self._next
        self._next += 1
        self._queue.append(_Pending(ticket, out, replay))
        return ticket

    def _finish(self, p: _Pending) -> None:
        with span("sm.server.collect"):
            self._complete(p)

    def _complete(self, p: _Pending) -> None:
        """The frame's outputs to the host, replayed on a failure."""
        try:
            self._done[p.ticket] = _to_host(p.outputs)
            return
        except RuntimeError:
            if not (self.retries and p.replay):
                raise
        err: RuntimeError | None = None
        for _ in range(self.retries):
            self.failures += 1
            if self.retry_backoff_s:
                time.sleep(self.retry_backoff_s)
            try:
                self._done[p.ticket] = _to_host(p.replay())
                return
            except RuntimeError as e:
                err = e
        raise err

    def collect(self, ticket: int):
        """Block until `ticket`'s frame is done; returns numpy arrays."""
        while ticket not in self._done:
            if not self._queue:
                raise KeyError(f"unknown or already-collected ticket {ticket}")
            self._finish(self._queue.popleft())
        return self._done.pop(ticket)

    def drain(self) -> list[Any]:
        """Collect every outstanding frame, in submission order."""
        tickets = [p.ticket for p in self._queue] + sorted(self._done)
        return [self.collect(t) for t in sorted(set(tickets))]


def _defaults(cfg: MSTConfig | None, sgbm_cfg: SGBMConfig | None):
    from .config import production_mst_config
    from .models.sgbm_mst import _default_sgbm_cfg

    if cfg is None:
        cfg = production_mst_config(128, forest_backend="device")
    return cfg, (_default_sgbm_cfg(cfg) if sgbm_cfg is None else sgbm_cfg)


def _volume_stage(h: int, w: int, d: int, guided: bool):
    """The front of every frame: shape check, float BGR pair, cost volumes."""
    from .apps.stereo_yin import builtin_cost_volumes

    def stage(left_bgr, right_bgr):
        for img in (left_bgr, right_bgr):
            if tuple(img.shape) != (h, w, 3):
                raise ValueError(f"server is built for ({h}, {w}, 3) frames, got {tuple(img.shape)}")
        with span("sm.volume"):
            left_bgr, right_bgr = left_bgr.float(), right_bgr.float()
            vl, vr = builtin_cost_volumes(left_bgr.flip(-1), right_bgr.flip(-1), d, guided=guided)
        return left_bgr, right_bgr, vl, vr

    return stage


def compile_sgbm_mst_server(
    h: int,
    w: int,
    cfg: MSTConfig | None = None,
    sgbm_cfg: SGBMConfig | None = None,
    fine_iterations: int = 4,
    refine_start: float | None = 2.0,
    max_neighbors: int = 2,
    right_seed: str = "disp2",
    capacity: int = 2,
    device: torch.device | str = "cuda",
    retries: int = 0,
    retry_backoff_s: float = 0.0,
    staged: bool = False,
    cache_dir: str | None = None,
    volume_guided: bool = True,
) -> StereoStreamServer:
    """Server for an HxW stream of BGR pairs: on-device adgrad cost volumes
    (guided-filtered unless volume_guided=False), the SGBM-seeded 3DMST
    frame, (left, right) disparity maps out. cfg defaults to
    `production_mst_config(128, forest_backend="device")`; its
    `scan_backend` is not read here (the scan is K2 on CUDA, its twin on
    CPU). `submit_pair(left, right, seed=None)` keys each frame's RNG by its
    ticket unless a seed is given, as the JAX server does."""
    from .models.mst import _fused_capacities
    from .models.sgbm_mst import _sgbm_mst_frame_fused

    _reject_unported(staged, cache_dir)
    cfg, sgbm_cfg = _defaults(cfg, sgbm_cfg)
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    volumes = _volume_stage(h, w, cfg.max_disp, volume_guided)

    def frame(left_bgr, right_bgr, key):
        left_bgr, right_bgr, vl, vr = volumes(left_bgr, right_bgr)
        return _sgbm_mst_frame_fused(
            left_bgr, right_bgr, vl, vr, key, cfg, sgbm_cfg, fine_iterations,
            refine_start, max_neighbors, h, w, tmax, adj_cap, right_seed,
        )

    server = StereoStreamServer(frame, device, capacity=capacity, retries=retries,
                                retry_backoff_s=retry_backoff_s)

    def submit_pair(left_bgr: np.ndarray, right_bgr: np.ndarray, seed: int | None = None) -> int:
        with span("sm.server.submit"):
            s = server._next if seed is None else seed
            return server.submit(left_bgr, right_bgr, trandom.PRNGKey(s, server.device))

    server.submit_pair = submit_pair  # type: ignore[attr-defined]
    return server


def _make_lr_stat(max_disp: int) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The LR-valid fraction of a frame's maps as a device scalar, for the
    scene-cut detector: one gather and compare, enqueued behind the frame;
    the host reads it only at _finish."""
    from .ops.postprocess import lr_consistency

    def stat(disp_l, disp_r):
        _, valid = lr_consistency(disp_l, disp_r, float(max_disp), fill=False)
        return valid.float().mean()

    return stat


class VideoStreamServer(StereoStreamServer):
    """Stateful video executor: frame N's maps seed frame N+1's plane labels
    on the device, with no host sync between them.

    Keyframes run `self.pipeline` (the SGBM-seeded frame): frame 0, the
    first frame after reset(), and, if `reseed_every` is set, every
    `reseed_every` frames since the last keyframe. Every other frame runs
    `refine_pipeline` on the previous frame's dense pre-LR-check maps. With
    `reuse_forest` the keyframe also returns both views' forests, which
    are chained on the device (`_capture_forest`) and refined on by the
    temporal frames until the next keyframe.

    `scene_cut_ratio` (0 disables) arms the scene-cut detector: a temporal
    frame whose LR-valid fraction falls below scene_cut_ratio x the last
    keyframe's is replayed through the keyframe pipeline with its own key
    at _finish (`scene_cuts` counts them). A failure replay of a temporal
    frame also runs it as a keyframe: the chained state may be lost.

    Difference from the JAX server: a replay re-chains `_prev` and
    `_prev_forest` only while its frame is the newest one submitted. JAX
    re-chains the forest of every replay (`stereomatch_tpu/serving.py:794`),
    which pairs a post-cut forest with the pre-cut seeds of the frames
    already submitted after it."""

    def __init__(
        self,
        keyframe_pipeline: Callable[..., Any],
        refine_pipeline: Callable[..., Any],
        device: torch.device | str,
        capacity: int = 2,
        reseed_every: int = 0,
        retries: int = 0,
        retry_backoff_s: float = 0.0,
        reuse_forest: bool = False,
        scene_cut_ratio: float = 0.0,
        lr_stat: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    ):
        super().__init__(keyframe_pipeline, device, capacity=capacity, retries=retries,
                         retry_backoff_s=retry_backoff_s)
        self.refine_pipeline = refine_pipeline
        self.reseed_every = reseed_every
        self.reuse_forest = reuse_forest
        self.scene_cut_ratio = scene_cut_ratio
        self._lr_stat = lr_stat
        self._always_replay = bool(scene_cut_ratio)
        self.scene_cuts = 0
        self._key_frac: float | None = None
        self._prev_ticket: int | None = None
        self._prev: Any = None  # (disp_l, disp_r) device tensors
        self._prev_forest: Any = None  # (raw_l, raw_r) device forest dicts
        self._since_key = 0  # frames submitted since the last keyframe, incl. it

    def _is_newest(self, ticket: int) -> bool:
        """No frame was submitted after `ticket`, and no reset(): inside its
        own submit the frame's ticket is still `_next`, after it
        `_prev_ticket`."""
        return ticket in (self._next, self._prev_ticket)

    def _capture_forest(self, out, ticket: int | None = None):
        """Keyframe-output post: chain both forests as device state and hand
        only the disparity pair on (the forests never go to the host). A
        replayed temporal frame (`ticket` given) chains them only while it
        is the newest frame."""
        disp_l, disp_r, raw_l, raw_r = out
        if ticket is None or self._is_newest(ticket):
            self._prev_forest = (raw_l, raw_r)
        return disp_l, disp_r

    def submit_pair(self, left_bgr, right_bgr, seed: int | None = None) -> int:
        with span("sm.server.submit"):
            return self._submit_pair(left_bgr, right_bgr, seed)

    def _submit_pair(self, left_bgr, right_bgr, seed: int | None) -> int:
        i = self._next
        key = trandom.PRNGKey(i if seed is None else seed, self.device)
        keyframe = self._prev is None or (
            self.reseed_every and self._since_key >= self.reseed_every
        )
        if keyframe:
            post = self._capture_forest if self.reuse_forest else None
            t = self.submit(left_bgr, right_bgr, key, _post=post)
            self._since_key = 1
        else:
            fargs = self._prev_forest if self.reuse_forest else ()
            t = self.submit(
                left_bgr, right_bgr, *self._prev, *fargs, key,
                _pipeline=self.refine_pipeline,
                _replay_args=(left_bgr, right_bgr, key),
                _replay_post=partial(self._capture_forest, ticket=i) if self.reuse_forest else None,
            )
            self._since_key += 1
        p = self._queue[-1]
        p.is_key = keyframe
        if self.scene_cut_ratio and self._lr_stat is not None:
            p.stat = self._lr_stat(p.outputs[0], p.outputs[1])
        self._prev = p.outputs
        self._prev_ticket = t
        return t

    def _complete(self, p: _Pending) -> None:
        super()._complete(p)
        if p.stat is None:
            return
        try:
            frac = float(p.stat)
        except RuntimeError:
            return  # lost with a failure that super() already replayed
        if p.is_key:
            self._key_frac = frac
            return
        ref = self._key_frac
        if not (ref and p.replay is not None and frac < self.scene_cut_ratio * ref):
            return
        # scene cut: rerun this frame as a keyframe (fresh SGBM seeds and,
        # with reuse_forest, fresh forests), with the frame's own key
        self.scene_cuts += 1
        with span("sm.server.scene_cut"):
            out = p.replay()
            self._done[p.ticket] = _to_host(out)
            if self._is_newest(p.ticket):
                self._prev = out
                self._since_key = 1
            if self._lr_stat is not None:
                self._key_frac = float(self._lr_stat(out[0], out[1]))

    def reset(self) -> None:
        """Drop the temporal state: the next frame is a keyframe and the
        keyframe cadence rephases to it."""
        self._prev = None
        self._prev_forest = None
        self._since_key = 0
        self._key_frac = None
        self._prev_ticket = None


def compile_mst_video_server(
    h: int,
    w: int,
    cfg: MSTConfig | None = None,
    sgbm_cfg: SGBMConfig | None = None,
    fine_iterations: int = 4,
    temporal_iterations: int | None = 2,
    refine_start: float | None = 2.0,
    temporal_refine_start: float | None = 4.0,
    max_neighbors: int = 2,
    right_seed: str = "disp2",
    reseed_every: int = 0,
    capacity: int = 2,
    device: torch.device | str = "cuda",
    retries: int = 0,
    retry_backoff_s: float = 0.0,
    staged: bool = False,
    reuse_forest: bool = False,
    cache_dir: str | None = None,
    volume_guided: bool = True,
    scene_cut_ratio: float = 0.0,
) -> VideoStreamServer:
    """Video server for an HxW stream: the SGBM-seeded keyframe frame and
    the temporal frame, which refines the previous frame's maps (clipped
    to [0, max_disp-1]) with `temporal_iterations` iterations entered at
    `temporal_refine_start` px and runs no SGBM. Without `reuse_forest`
    both frames build their forests; with it the temporal frame refines on
    the last keyframe's forests and builds none. Same defaults, RNG stream
    and frame semantics as the JAX function; see VideoStreamServer."""
    from .models.mst import _fused_capacities
    from .models.sgbm_mst import (
        _gray_from_bgr,
        _mst_refine_frame_fused,
        _refine_view_given_forest,
        _seed_pair,
        _sgbm_mst_frame_fused,
        _view_forest,
    )

    _reject_unported(staged, cache_dir)
    cfg, sgbm_cfg = _defaults(cfg, sgbm_cfg)
    ti = fine_iterations if temporal_iterations is None else temporal_iterations
    trs = refine_start if temporal_refine_start is None else temporal_refine_start
    tmax, adj_cap = _fused_capacities(h, w, cfg)
    top = float(cfg.max_disp - 1)
    volumes = _volume_stage(h, w, cfg.max_disp, volume_guided)

    if reuse_forest:
        def keyframe(left_bgr, right_bgr, k):
            left_bgr, right_bgr, vl, vr = volumes(left_bgr, right_bgr)
            sl, sr = _seed_pair(_gray_from_bgr(left_bgr), _gray_from_bgr(right_bgr),
                                sgbm_cfg, right_seed)
            kl, kr = trandom.split(k)
            fl = _view_forest(left_bgr, cfg, tmax, adj_cap)
            fr = _view_forest(right_bgr, cfg, tmax, adj_cap)
            dl = _refine_view_given_forest(fl, vl, sl, kl, cfg, h, w, tmax, fine_iterations,
                                           refine_start, max_neighbors)
            dr = _refine_view_given_forest(fr, vr, sr, kr, cfg, h, w, tmax, fine_iterations,
                                           refine_start, max_neighbors)
            return dl, dr, fl, fr

        def refine(left_bgr, right_bgr, pdl, pdr, fl, fr, k):
            _, _, vl, vr = volumes(left_bgr, right_bgr)
            kl, kr = trandom.split(k)
            dl = _refine_view_given_forest(fl, vl, torch.clamp(pdl, 0.0, top), kl, cfg, h, w,
                                           tmax, ti, trs, max_neighbors)
            dr = _refine_view_given_forest(fr, vr, torch.clamp(pdr, 0.0, top), kr, cfg, h, w,
                                           tmax, ti, trs, max_neighbors)
            return dl, dr
    else:
        def keyframe(left_bgr, right_bgr, key):
            left_bgr, right_bgr, vl, vr = volumes(left_bgr, right_bgr)
            return _sgbm_mst_frame_fused(
                left_bgr, right_bgr, vl, vr, key, cfg, sgbm_cfg, fine_iterations,
                refine_start, max_neighbors, h, w, tmax, adj_cap, right_seed,
            )

        def refine(left_bgr, right_bgr, prev_dl, prev_dr, key):
            left_bgr, right_bgr, vl, vr = volumes(left_bgr, right_bgr)
            return _mst_refine_frame_fused(
                left_bgr, right_bgr, vl, vr, torch.clamp(prev_dl, 0.0, top),
                torch.clamp(prev_dr, 0.0, top), key, cfg, ti, trs, max_neighbors,
                h, w, tmax, adj_cap,
            )

    return VideoStreamServer(
        keyframe, refine, device, capacity=capacity, reseed_every=reseed_every,
        retries=retries, retry_backoff_s=retry_backoff_s, reuse_forest=reuse_forest,
        scene_cut_ratio=scene_cut_ratio, lr_stat=_make_lr_stat(cfg.max_disp),
    )
