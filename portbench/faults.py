"""Faults planted in the program's timed path, to show that `correct` catches
them: each replaces one function of the program in this process and
returns a callable that puts it back.

- `state_unchanged`: a refine returns the labels it was seeded with (the
  video cell's temporal frames hand the state on unchanged);
- `half_left_out`: the lower half of each frame is left unrefined (3DMST)
  or invalid (SGBM);
- `answer_altered`: every disparity is off by one pixel where it is
  produced.

    python3 -m portbench.control --workload <cell> --fault <name> --seeds ...

reads them on the card; `portbench/tests/test_portbench_check.py` at the
rehearsal size.
"""

from __future__ import annotations

MST_FAULTS = ("state_unchanged", "half_left_out", "answer_altered")
SGBM_FAULTS = ("half_left_out", "answer_altered")


def _swap(module, name: str, new):
    old = getattr(module, name)
    setattr(module, name, new)
    return lambda: setattr(module, name, old)


def plant(spec: dict, fault: str):
    """Break the path that `spec`'s configuration runs; returns the undo."""
    import torch

    if "mst" in spec:
        from stereomatch_tpu_torch.models import sgbm_mst

        if fault not in MST_FAULTS:
            raise ValueError(f"no 3DMST fault {fault!r}")
        real = sgbm_mst._refine_view_given_forest

        def broken(raw, vol, seed_disp, k, cfg, h, w, *rest):
            seed = torch.clamp(seed_disp, 0.0, float(cfg.max_disp - 1))
            if fault == "state_unchanged":
                return seed
            out = real(raw, vol, seed_disp, k, cfg, h, w, *rest)
            if fault == "half_left_out":
                return torch.cat([out[: h // 2], seed[h // 2:]])
            return out + 1.0

        return _swap(sgbm_mst, "_refine_view_given_forest", broken)

    from stereomatch_tpu_torch import pipelines
    from stereomatch_tpu_torch.ops import sgbm

    if fault == "half_left_out":
        real_banded = sgbm.sgbm_disparity_banded

        def banded(left, right, cfg, *a, **k):
            out = real_banded(left, right, cfg, *a, **k)
            d = out.disparity.clone()
            d[d.shape[0] // 2:] = cfg.min_disp - 1
            return out._replace(disparity=d)

        return _swap(sgbm, "sgbm_disparity_banded", banded)
    if fault == "answer_altered":
        real_speckle = pipelines._filter_speckles
        return _swap(pipelines, "_filter_speckles", lambda d, cfg: real_speckle(d, cfg) + 1.0)
    raise ValueError(f"no SGBM fault {fault!r}")
