"""The JAX package's classical, PatchMatch, coarse-to-fine 3DMST and
coupled-WTA engines on one synthetic scene, on the CPU, scored as
tests/test_gt_battery.py scores each engine: the reference digits that
`chip_smoke.py`'s gates are set from where the battery's own gates (set at
480x640x64 and 240x320x32) are missed at a larger size.

    JAX_PLATFORMS=cpu python3 jax_classic_gt.py sgbm bm census costvolume \
        pm coupled sgbm_banded c2f c2f_none coupled_wta [--shape 960 1280 128]

One JSON line per engine: its metrics, seconds and the process's peak RSS.
At 960x1280x128 the costvolume and coupled engines hold about 10 GB and
census is run in 64-row bands with an 8-row halo, which is exact: the
census window reaches 8 rows and the shifted stacks move along x only.
`pm` and `coupled` run the CLI's configurations (`apps/cli.py`'s `pm` and
`coupled` engines): the PatchMatch pipeline at max_disp D - 1, 10
iterations, the adgrad metric, scored on its post-processed left map; the
coupled PatchMatch-Huber engine on the built-in guided left volume, key 0,
scored on its smoothed field. `sgbm_banded` is `sgbm_pipeline` with
`SGBMConfig()` and speckle at the reference's 2048x1536 FLIR frame and 256
disparities, where it streams the rows in bands (unless `--shape` is
given). `c2f` is `mst_stereo_c2f` as tests/test_engine_gates.py runs it
(k=2, 30 coarse and 10 fine iterations, 2TGV at 60 iterations; the
battery's c=2000 and min_cc_size=100, the host forest) on the built-in
guided volumes, `c2f_none` the same with no prior; both are LR-checked
again and scored on the surviving pixels, with the share of pixels that
survive as `valid`. `coupled_wta` is `coupled_wta_stereo` with
`CoupledConfig(max_disp=D - 1)` and `TGVParams()` on the built-in guided
left volume, the left luma its guide, scored on its disparity.
`stereo_test` is the StereoTest app (`apps/stereo_test.py`, SGBM at
min_disp 16 and 256 disparities on the whole frame) on the frame written
as 8-bit PNG under the FLIR cameras' names with the identity rig of
`chip_smoke.py`, at the 2048x1536 FLIR frame unless `--shape` is given
(its third number is then ignored: the app searches [16, 272)).
At 2048x1536 the JAX app's whole-frame SGBM holds about 30 GB of host
memory (7.5 GB at 768x1024); `stereo_test_banded` computes the same map
through the JAX package's band-streamed SGBM (`ops.sgbm.
sgbm_disparity_banded`, about 6 GB) on the same 8-bit frame's luma, whose
maps differ from the whole frame's only in float32 jitter; run both at a
size that fits to see the digits agree.
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

ENGINES = ("sgbm", "bm", "census", "costvolume", "pm", "coupled", "sgbm_banded", "c2f",
           "c2f_none", "coupled_wta", "stereo_test", "stereo_test_banded")
SCENE_SEED = 0  # chip_smoke.py's scene
# the engines run at another shape than --shape's default
ENGINE_SHAPES = {"sgbm_banded": (1536, 2048, 256), "stereo_test": (1536, 2048, 256),
                 "stereo_test_banded": (1536, 2048, 256)}


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


def _guided_volumes(rgb_l, rgb_r, d: int):
    import jax.numpy as jnp

    from stereomatch_tpu.apps.stereo_yin import builtin_cost_volumes

    return builtin_cost_volumes(jnp.asarray(np.asarray(rgb_l, np.float32)),
                                jnp.asarray(np.asarray(rgb_r, np.float32)), d)


def run(engine: str, rgb_l, rgb_r, d: int):
    """The engine's map as tests/test_gt_battery.py scores it; for the
    3DMST engines (left, right) before the LR check."""
    if engine == "sgbm":
        return pipelines.sgbm_pipeline(rgb_l, rgb_r, SGBMConfig(min_disp=0, num_disp=d,
                                                                block_size=5))
    if engine == "sgbm_banded":
        return pipelines.sgbm_pipeline(rgb_l, rgb_r, SGBMConfig(), speckle=True)
    if engine == "stereo_test":
        import tempfile

        from chip_smoke import identity_calibration, write_calibration, write_frame_pair
        from stereomatch_tpu.apps import stereo_test

        with tempfile.TemporaryDirectory() as tmp:
            write_frame_pair(tmp, 20, rgb_l[..., ::-1], rgb_r[..., ::-1])
            cal = f"{tmp}/rig.yml"
            write_calibration(cal, **identity_calibration(*rgb_l.shape[:2]))
            return stereo_test.run(tmp, 20, cal, f"{tmp}/out", verbose=False)[0]
    if engine == "stereo_test_banded":
        from stereomatch_tpu.ops.sgbm import sgbm_disparity_banded

        l8, r8 = (np.clip(np.round(x), 0, 255).astype(np.uint8) for x in (rgb_l, rgb_r))
        out = sgbm_disparity_banded(pipelines._gray255(l8), pipelines._gray255(r8),
                                    SGBMConfig(min_disp=16, num_disp=256))
        return np.asarray(out.disparity)
    if engine in ("c2f", "c2f_none"):
        from stereomatch_tpu.config import MSTConfig
        from stereomatch_tpu.models.mst import mst_stereo_c2f

        lv, rv = _guided_volumes(rgb_l, rgb_r, d)
        cfg = MSTConfig(max_disp=d, iterations=30, min_cc_size=100, c=2000.0,
                        smoothness_prior="2TGV" if engine == "c2f" else "NONE",
                        smoothness_iters=60)
        out = mst_stereo_c2f(np.asarray(pipelines.to_bgr255(rgb_l)),
                             np.asarray(pipelines.to_bgr255(rgb_r)), lv, rv, cfg, seed=0, k=2,
                             coarse_iterations=30, fine_iterations=10)
        return np.asarray(out.left_disp), np.asarray(out.right_disp)
    if engine == "coupled_wta":
        import jax.numpy as jnp

        from stereomatch_tpu.models.coupled import coupled_wta_stereo
        from stereomatch_tpu.ops.tgv import TGVParams

        lvol, _ = _guided_volumes(rgb_l, rgb_r, d)
        rgb = np.asarray(rgb_l, np.float32)
        luma = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
        out = coupled_wta_stereo(lvol, jnp.asarray(luma), CoupledConfig(max_disp=d - 1),
                                 TGVParams())
        return np.asarray(out.disparity)
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
    ap.add_argument("--shape", nargs=3, type=int, default=None, metavar=("H", "W", "D"),
                    help="every engine's shape (default 960 1280 128, sgbm_banded's "
                         "1536 2048 256)")
    args = ap.parse_args()
    scenes = {}
    for engine in args.engines:
        h, w, d = args.shape or ENGINE_SHAPES.get(engine, (960, 1280, 128))
        if (h, w, d) not in scenes:
            scenes = {(h, w, d): render_scene(SCENE_SEED, h, w, d)}
        sc = scenes[(h, w, d)]
        mask = scene_eval_mask(sc)
        rgb_l, rgb_r = sc.left[..., ::-1], sc.right[..., ::-1]  # the scenes are BGR
        t0 = time.perf_counter()
        est = run(engine, rgb_l, rgb_r, d)
        sec = time.perf_counter() - t0
        extra = {}
        if isinstance(est, tuple):  # a 3DMST pair: LR-check, score the survivors
            import jax.numpy as jnp

            from stereomatch_tpu.ops.postprocess import lr_consistency

            est, valid = lr_consistency(jnp.asarray(est[0]), jnp.asarray(est[1]), float(d),
                                        fill=False)
            mask = mask & np.asarray(valid)
            extra["valid"] = float(mask.mean())
        mm = disparity_metrics(np.asarray(est, np.float32), sc.disp_left, mask)
        print(json.dumps({
            "engine": engine, "shape": [h, w, d], "seconds": sec,
            "max_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
            **extra, **{k: float(v) for k, v in mm.items()}}), flush=True)


if __name__ == "__main__":
    main()
