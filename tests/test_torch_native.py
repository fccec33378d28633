"""The port's host forest builder (stereomatch_tpu_torch/native/) and its
upload (ops/mst.py::forest_arrays) against the JAX package.

Both packages run the same C++ (the two treebuild.cpp are byte-equal), so
every array of the native forest is held exactly equal; so are
pyforest.forest_from_labels on the same labels and the integer arrays and
masks of forest_arrays. w_exp / rel_gd are copied, held within 1e-6."""

import dataclasses
import pathlib
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu import native as jnative
from stereomatch_tpu.native import pyforest as jpyforest
from stereomatch_tpu.ops import mst as jmst
from stereomatch_tpu.synthetic import render_scene
from stereomatch_tpu_torch import native as tnative
from stereomatch_tpu_torch.interop import key_from_jax, native_forest_from_numpy
from stereomatch_tpu_torch.native import build as tbuild
from stereomatch_tpu_torch.native import pyforest as tpyforest
from stereomatch_tpu_torch.ops import mst as tmst

GAMMA = 1.0 / 12.0


def _scene_weights(h=120, w=160, seed=1):
    return jnative.color_edge_weights(render_scene(seed, h, w, min(32, w // 4)).left)


def _assert_forests_equal(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_treebuild_source_byte_equal():
    jax_source = pathlib.Path(jnative.__file__).with_name("treebuild.cpp")
    assert tbuild.SOURCE.read_bytes() == jax_source.read_bytes()


def test_library_builds_under_build_dir(monkeypatch, tmp_path):
    """Concurrent builds into an empty directory publish one whole library
    and leave no temporary file; nothing is written next to the sources."""
    assert tbuild.BUILD_DIR == tbuild.SOURCE.parents[2] / "build" / "native"
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "native")
    paths, errors = [], []

    def run():
        try:
            paths.append(tbuild.build())
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1 and paths[0].startswith(str(tmp_path / "native"))
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == [paths[0].rsplit("/", 1)[1]]
    assert not list(tbuild.SOURCE.parent.glob("*.so"))


def test_color_edge_weights_equal_jax(rng):
    img = (rng.random((30, 40, 3)) * 255).astype(np.float32)
    for t, j in zip(tnative.color_edge_weights(img), jnative.color_edge_weights(img)):
        np.testing.assert_array_equal(t, j)
    for t, j in zip(tnative.color_edge_weights(img[..., 0]), jnative.color_edge_weights(img[..., 0])):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("delta", [1.0, 4.0, 40.0])
def test_build_forest_equals_jax(delta):
    wr, wd = _scene_weights()
    j = jnative.build_forest(wr, wd, 2000.0, 100, GAMMA, delta)
    t = tnative.build_forest(wr, wd, 2000.0, 100, GAMMA, delta)
    _assert_forests_equal(t, j)
    np.testing.assert_array_equal(t.seg_root_mask(), j.seg_root_mask())
    assert t.num_nodes == 120 * 160


def test_build_forest_rejects_bad_shapes():
    with pytest.raises(ValueError, match="edge weight shapes"):
        tnative.build_forest(np.zeros((4, 5), np.float32), np.zeros((3, 5), np.float32),
                             100.0, 2, GAMMA)


def test_forest_from_labels_equals_jax(rng):
    h, w = 48, 64
    wr, wd = _scene_weights(h, w, seed=3)
    # blocky labels with one ragged region
    labels = (np.arange(h)[:, None] // 16) * 4 + (np.arange(w)[None, :] // 17)
    labels[5:19, 3:40] = 99
    for delta in (1.0, 40.0):
        t = tpyforest.forest_from_labels(labels, wr, wd, GAMMA, delta)
        j = jpyforest.forest_from_labels(labels, wr, wd, GAMMA, delta)
        _assert_forests_equal(t, j)


@pytest.mark.parametrize("exc", [OSError("no g++"),
                                 subprocess.CalledProcessError(1, ["g++"])])
def test_failed_native_build_raises(monkeypatch, exc):
    """With no buildable or loadable library the host forest raises, naming
    g++ and native/build.py: there is no second builder to fall back to."""
    wr, wd = _scene_weights(36, 48, seed=2)

    def broken():
        raise exc

    monkeypatch.setattr(tnative, "_load", broken)
    with pytest.raises(RuntimeError, match=r"native/build\.py.*g\+\+"):
        tnative.build_forest(wr, wd, 800.0, 20, GAMMA, 4.0)


def test_native_forest_from_numpy_roundtrip():
    wr, wd = _scene_weights(48, 64)
    j = jnative.build_forest(wr, wd, 2000.0, 100, GAMMA, 4.0)
    d = dataclasses.asdict(j)
    d["pixel_of_node"] = d["pixel_of_node"].astype(np.int64)  # any integer type is taken
    t = native_forest_from_numpy(d)
    _assert_forests_equal(t, j)
    assert t.pixel_of_node is not j.pixel_of_node


@pytest.mark.parametrize("delta", [1.0, 4.0, 40.0])
def test_forest_arrays_equals_jax(delta):
    wr, wd = _scene_weights()
    j = jnative.build_forest(wr, wd, 2000.0, 100, GAMMA, delta)
    fj = jmst.forest_arrays(j)
    ft = tmst.forest_arrays(native_forest_from_numpy(dataclasses.asdict(j)), "cpu")
    n = 120 * 160
    for name in tmst.ForestArrays._fields:
        got, want = getattr(ft, name), getattr(fj, name)
        if isinstance(got, int):
            assert got == want, name
            continue
        want = np.asarray(want)
        assert got.is_contiguous(), name
        if want.dtype == np.bool_:
            assert got.dtype == torch.bool, name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        elif np.issubdtype(want.dtype, np.integer):
            assert got.dtype == torch.int64, name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            assert got.dtype == torch.float32, name
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6, err_msg=name)
    assert ft.cut_child_idx.shape == (3, n)
    assert ft.num_trees == j.num_trees == ft.tree_start.shape[0] - 1
    # the fused ancestor sum stores each in-event's scan at its node: it
    # needs in_pos[euler_src[j]] == j at every in-event
    ins = torch.nonzero(ft.euler_is_in)[:, 0]
    torch.testing.assert_close(ft.in_pos[ft.euler_src[ins]], ins)
    assert ins.numel() == n


def test_one_tree_forest():
    """MSTConfig's own c=5000 / min_cc_size=200 on a small textured image
    leaves one tree and no neighbours: adj_list is padded to one entry and
    the candidates fall back to the tree itself, as in JAX."""
    rng = np.random.default_rng(5)
    img = (rng.random((24, 32, 3)) * 40).astype(np.float32)
    wr, wd = jnative.color_edge_weights(img)
    j = jnative.build_forest(wr, wd, 5000.0, 200, GAMMA, 4.0)
    assert j.num_trees == 1 and j.adj_list.size == 0
    fj = jmst.forest_arrays(j)
    ft = tmst.forest_arrays(tnative.build_forest(wr, wd, 5000.0, 200, GAMMA, 4.0), "cpu")
    assert ft.adj_list.tolist() == [0]
    n, d = 24 * 32, 16
    a = (rng.random(n).astype(np.float32) - 0.5) * 0.2
    b = (rng.random(n).astype(np.float32) - 0.5) * 0.2
    c = rng.random(n).astype(np.float32) * d
    key = jax.random.PRNGKey(2)
    deltas = tmst.refine_deltas(d, device="cpu")
    cj = jmst.make_candidate_fn(key, jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), fj, d, 3,
                                *jmst.refine_deltas(d))
    ct = tmst.make_candidate_fn(key_from_jax(key, "cpu"), *(torch.from_numpy(x) for x in (a, b, c)),
                                ft, d, 3, *deltas)
    for k in range(3 + deltas[0].shape[0]):
        for w_, g_ in zip(cj(k), ct(k)):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-6, atol=1e-6)
