"""Application entry points of the port (port of `stereomatch_tpu/apps/`):
the reference's executables re-imagined (SURVEY.md §2.1). Interactive
viewers (imshow/PCL) become file outputs (disparity PNGs, PLY/PCD clouds).
Each runs on the card unless `--device` (or `device=`) says otherwise.

  stereo_test — StereoTest (src/stereo_opencv.cpp:47-225): FLIR pair ->
                rectify -> SGBM -> 3D cloud.
  stereo_yin  — StereoYin (src/stereo_Yin.cpp:53-266): rectify -> 3DMST
                (mc-cnn or built-in cost volume) -> clamp -> 3D cloud.
  stream      — the FLIR sequence through the cost-volume pipeline or the
                streaming 3DMST (video mode, scene cuts, resume).
  cli         — the legacy full CLI (src/stereo_opencv (copy).cpp:47-349):
                --algorithm, --blocksize, --max-disparity, --scale, -o/-p,
                extended with this framework's additional engines.

Run as modules: `python -m stereomatch_tpu_torch.apps.stereo_test --help`.
"""
