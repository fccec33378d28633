"""The JAX package's classical and PatchMatch engines on one synthetic
scene, on the CPU, scored as tests/test_gt_battery.py scores each engine:
the reference digits that `chip_smoke.py`'s CLASSIC_GATES and PM_GATES are
set from where the battery's own gates (set at 480x640x64 and 240x320x32)
are missed at a larger size.

    JAX_PLATFORMS=cpu python3 jax_classic_gt.py sgbm bm census costvolume \
        pm coupled [--shape 960 1280 128]

One JSON line per engine: its metrics, seconds and the process's peak RSS.
At 960x1280x128 the costvolume and coupled engines hold about 10 GB and
census is run in 64-row bands with an 8-row halo, which is exact: the
census window reaches 8 rows and the shifted stacks move along x only.
`pm` and `coupled` run the CLI's configurations (`apps/cli.py`'s `pm` and
`coupled` engines): the PatchMatch pipeline at max_disp D - 1, 10
iterations, the adgrad metric, scored on its post-processed left map; the
coupled PatchMatch-Huber engine on the built-in guided left volume, key 0,
scored on its smoothed field.
This script is the JAX side; the port (`stereomatch_tpu_torch`) never
imports it.
"""

from __future__ import annotations

import argparse
import json
import resource
import time

import numpy as np

from stereomatch_tpu import pipelines
from stereomatch_tpu.config import (
    BMConfig, CensusConfig, CostVolumeConfig, CostVolumePipelineConfig, CoupledConfig,
    PatchMatchConfig, SGBMConfig,
)
from stereomatch_tpu.eval import disparity_metrics
from stereomatch_tpu.synthetic import render_scene, scene_eval_mask

ENGINES = ("sgbm", "bm", "census", "costvolume", "pm", "coupled")
SCENE_SEED = 0  # chip_smoke.py's scene


def census_banded(rgb_l, rgb_r, d: int, step: int = 64, halo: int = 8) -> np.ndarray:
    """census_pipeline in row bands; each band's inner rows equal the whole
    frame's, and the frame's interior rule holds at the top and bottom."""
    h = rgb_l.shape[0]
    parts = []
    for y0 in range(0, h, step):
        y1 = min(h, y0 + step)
        a, b = max(0, y0 - halo), min(h, y1 + halo)
        band = pipelines.census_pipeline(rgb_l[a:b], rgb_r[a:b], CensusConfig(d_max=d - 1))
        parts.append(band[y0 - a: y1 - a])
    disp = np.concatenate(parts)
    disp[:halo] = 0
    disp[h - halo:] = 0
    return disp


def run(engine: str, rgb_l, rgb_r, d: int):
    """The engine's map as tests/test_gt_battery.py scores it."""
    if engine == "sgbm":
        return pipelines.sgbm_pipeline(rgb_l, rgb_r, SGBMConfig(min_disp=0, num_disp=d,
                                                                block_size=5))
    if engine == "bm":
        disp = pipelines.bm_pipeline(rgb_l, rgb_r, BMConfig(num_disp=d, block_size=9))
        return np.where(disp < 0, 0, disp)
    if engine == "census":
        return census_banded(rgb_l, rgb_r, d)
    if engine == "pm":
        cfg = PatchMatchConfig(max_disp=float(d - 1), iterations=10, metric="adgrad")
        return pipelines.patchmatch_pipeline(rgb_l, rgb_r, cfg)[0]
    if engine == "coupled":
        import jax
        import jax.numpy as jnp

        from stereomatch_tpu.apps.stereo_yin import builtin_cost_volumes
        from stereomatch_tpu.models.coupled import coupled_patchmatch_stereo

        lvol, _ = builtin_cost_volumes(jnp.asarray(np.asarray(rgb_l, np.float32)),
                                       jnp.asarray(np.asarray(rgb_r, np.float32)), d)
        out = coupled_patchmatch_stereo(jax.random.PRNGKey(0), pipelines.to_bgr255(rgb_l),
                                        lvol, CoupledConfig(max_disp=d - 1))
        return np.asarray(out.smoothed)
    cfg = CostVolumePipelineConfig(volume=CostVolumeConfig(min_disp=0, max_disp=d - 1))
    return pipelines.costvolume_pipeline(rgb_l, rgb_r, cfg, lr_check=True)[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("engines", nargs="+", choices=ENGINES)
    ap.add_argument("--shape", nargs=3, type=int, default=(960, 1280, 128),
                    metavar=("H", "W", "D"))
    args = ap.parse_args()
    h, w, d = args.shape
    sc = render_scene(SCENE_SEED, h, w, d)
    mask = scene_eval_mask(sc)
    rgb_l, rgb_r = sc.left[..., ::-1], sc.right[..., ::-1]  # the scenes are BGR
    for engine in args.engines:
        t0 = time.perf_counter()
        est = run(engine, rgb_l, rgb_r, d)
        sec = time.perf_counter() - t0
        mm = disparity_metrics(np.asarray(est, np.float32), sc.disp_left, mask)
        print(json.dumps({
            "engine": engine, "shape": [h, w, d], "seconds": sec,
            "max_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
            **{k: float(v) for k, v in mm.items()}}), flush=True)


if __name__ == "__main__":
    main()
