"""The port's own copies of the JAX package's framework-free modules: the
configs of stereomatch_tpu_torch/config.py equal the JAX package's field by
field, and the scenes of stereomatch_tpu_torch/synthetic.py equal its scenes
byte for byte. Also the one helper the torch tests use to hand the port its
own config built from a JAX config's fields (`port_cfg`), and the default
device of the port's public entry points."""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest

from stereomatch_tpu import config as jconfig
from stereomatch_tpu import synthetic as jsynthetic
from stereomatch_tpu_torch import config as tconfig
from stereomatch_tpu_torch import synthetic as tsynthetic

CONFIG_CLASSES = [
    "CensusConfig", "BMConfig", "SGBMConfig", "CostVolumeConfig", "ZNCCConfig",
    "GuidedFilterConfig", "DenoiseConfig", "MSTConfig", "CostVolumePipelineConfig",
    "PatchMatchConfig", "WeightedMedianConfig", "CoupledConfig", "LRCheckConfig",
    "RectifyConfig", "SGBMPipelineConfig",
]


def port_cfg(cfg):
    """The port's config of the same class name, built from `cfg`'s fields
    (a JAX package config); a field that holds a config (as
    CostVolumePipelineConfig's do) is converted the same way."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields = {k: port_cfg(v) if dataclasses.is_dataclass(v) else v for k, v in fields.items()}
    return getattr(tconfig, type(cfg).__name__)(**fields)


def _as_fields(v):
    """A config compared by its fields (recursively), anything else as is:
    the two packages' configs are of different classes."""
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, tuple((f.name, _as_fields(getattr(v, f.name)))
                                        for f in dataclasses.fields(v)))
    return v


def _fields(cls):
    return [(f.name, _as_fields(f.default), str(f.type)) for f in dataclasses.fields(cls)]


def _values(cfg):
    return [(f.name, _as_fields(getattr(cfg, f.name))) for f in dataclasses.fields(cfg)]


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_copy_equals_jax(name):
    """Same fields in the same order, same defaults and annotations, same
    frozenness, and equal default instances and derived values."""
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    assert _fields(t) == _fields(j)
    assert t.__dataclass_params__.frozen and j.__dataclass_params__.frozen
    assert _values(t()) == _values(j())
    assert port_cfg(j()) == t()
    if name == "SGBMConfig":
        for kw in (dict(), dict(block_size=3, channels=3), dict(p1=7, p2=90)):
            assert t(**kw).resolved_p1p2() == j(**kw).resolved_p1p2()
    if name == "CostVolumeConfig":
        assert t(min_disp=3, max_disp=40).num_disp == j(min_disp=3, max_disp=40).num_disp
    if name == "CostVolumePipelineConfig":
        jc = jconfig.replace(j(), volume=jconfig.CostVolumeConfig(max_disp=63),
                             denoise=jconfig.DenoiseConfig(iterations=7))
        tc = port_cfg(jc)
        assert type(tc.volume) is tconfig.CostVolumeConfig and tc.volume.num_disp == 64
        assert _values(tc) == _values(jc)
        assert tconfig.replace(tc, guided=tconfig.GuidedFilterConfig(radius=4)).guided.radius == 4


@pytest.mark.parametrize("max_disp", [16, 24, 128, 256])
@pytest.mark.parametrize("on_tpu,overrides", [
    (True, {}),
    (False, {}),
    (False, dict(min_cc_size=20, c=800.0, forest_backend="device")),
    (True, dict(carry_iters=3, volume_dtype="float32", iterations=7)),
])
def test_production_mst_config_equals_jax(max_disp, on_tpu, overrides):
    j = jconfig.production_mst_config(max_disp, on_tpu=on_tpu, **overrides)
    t = tconfig.production_mst_config(max_disp, on_tpu=on_tpu, **overrides)
    assert _values(t) == _values(j)
    assert port_cfg(j) == t
    assert list(inspect.signature(tconfig.production_mst_config).parameters) == list(
        inspect.signature(jconfig.production_mst_config).parameters)


def _assert_scene_bytes_equal(t, j):
    assert type(t).__name__ == type(j).__name__ and t._fields == j._fields
    for name, a, b in zip(j._fields, t, j):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
        else:
            assert a == b, name


@pytest.mark.parametrize("seed,h,w,d", [(0, 48, 64, 16), (3, 60, 90, 24), (7, 120, 160, 32)])
def test_render_scene_bytes_equal_jax(seed, h, w, d):
    t = tsynthetic.render_scene(seed, h, w, d)
    j = jsynthetic.render_scene(seed, h, w, d)
    _assert_scene_bytes_equal(t, j)
    np.testing.assert_array_equal(tsynthetic.scene_eval_mask(t), jsynthetic.scene_eval_mask(j))


@pytest.mark.parametrize("seed,n,h,w,d,drift", [(2, 3, 48, 64, 16, 2.0), (5, 2, 80, 96, 24, 3.0)])
def test_render_sequence_bytes_equal_jax(seed, n, h, w, d, drift):
    ts = tsynthetic.render_sequence(seed, n, h, w, d, drift=drift)
    js = jsynthetic.render_sequence(seed, n, h, w, d, drift=drift)
    assert len(ts) == len(js) == n
    for t, j in zip(ts, js):
        _assert_scene_bytes_equal(t, j)


@pytest.mark.parametrize("module,name", [
    ("models.sgbm_mst", "sgbm_seed_disparities"),
    ("models.sgbm_mst", "sgbm_mst_stereo"),
    ("models.sgbm_mst", "sgbm_mst_stereo_fused"),
    ("models.sgbm_mst", "mst_stereo_temporal_fused"),
    ("models.sgbm_mst", "sgbm_mst_video"),
    ("models.mst", "build_view_forest"),
    ("models.mst", "mst_stereo"),
    ("models.mst", "mst_stereo_fused"),
    ("models.mst", "mst_stereo_seeded"),
    ("pipelines", "to_bgr255"),
    ("pipelines", "mst_pipeline"),
    ("pipelines", "sgbm_mst_pipeline"),
    ("pipelines", "census_pipeline"),
    ("pipelines", "bm_pipeline"),
    ("pipelines", "sgbm_pipeline"),
    ("pipelines", "costvolume_pipeline"),
    ("pipelines", "patchmatch_pipeline"),
    ("ops.segmentation", "segment_image"),
    ("serving", "compile_sgbm_mst_server"),
    ("serving", "compile_mst_video_server"),
    ("random", "PRNGKey"),
    ("interop", "forest_dict_from_numpy"),
    ("interop", "forest_from_numpy"),
    ("interop", "key_from_jax"),
    ("interop", "plane_state_from_numpy"),
    ("ops.mst", "refine_deltas"),
    ("ops.mst", "forest_arrays"),
])
def test_entry_points_default_to_cuda(module, name):
    """A public entry point, and every public function that makes tensors,
    runs on the card unless the caller asks for another device."""
    fn = getattr(importlib.import_module(f"stereomatch_tpu_torch.{module}"), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
