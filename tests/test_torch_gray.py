"""`pipelines._gray255`: the gray that the classical pipelines (census,
BM, SGBM) take, computed on the target device from the image as it was
handed in, and bit-equal to the JAX package's numpy luma,
(0.299 R + 0.587 G) + 0.114 B in float32.

The SGBM cell's `correct` holds its map to the reference's exactly, and
its BT cost floors a quarter of non-integer gray, so one ulp of gray can
flip a pixel: every case here compares bits. A C-contiguous image, an RGB
view of a C-contiguous BGR buffer and a 2-D gray upload with no host
copy; `_gray255.host_copies` counts the rest.

The tests marked `cuda` run the same on the card (the benchmark's
2048x1536 views, the span's launches, a band-streamed map) and skip
without one. The file imports neither jax nor anything from conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_gray.py -q
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from stereomatch_tpu_torch import pipelines  # noqa: E402
from stereomatch_tpu_torch.config import SGBMConfig  # noqa: E402
from stereomatch_tpu_torch.ops.sgbm import sgbm_disparity_banded  # noqa: E402
from stereomatch_tpu_torch.synthetic import render_scene  # noqa: E402


def _numpy_gray(img) -> np.ndarray:
    """The luma as the JAX package (and the port before) computes it."""
    arr = np.asarray(img).astype(np.float32)
    if arr.ndim == 3:
        arr = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
    return np.ascontiguousarray(arr)


def _bits_equal(got: torch.Tensor, want: np.ndarray) -> bool:
    g = got.cpu().numpy()
    return g.dtype == np.float32 and g.shape == want.shape and np.array_equal(
        g.view(np.uint32), want.view(np.uint32))


def _image(kind: str, dtype) -> np.ndarray:
    rng = np.random.default_rng(7)
    if dtype == np.uint8:
        bgr = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    else:  # non-integer values, where the order of the sum shows
        bgr = rng.uniform(0.0, 255.0, (37, 53, 3)).astype(dtype)
    return {
        "rgb": bgr,  # C-contiguous, taken as RGB
        "bgr_view": bgr[..., ::-1],  # an RGB view of a BGR buffer, negative strides
        "gray": np.ascontiguousarray(bgr[..., 1]),
        "strided": bgr[:, ::2],  # no C-contiguous buffer behind it
    }[kind]


CASES = [(kind, dtype, kind == "strided") for kind in ("rgb", "bgr_view", "gray", "strided")
         for dtype in (np.uint8, np.float32)]
CASES += [("bgr_view", np.float64, False), ("scene", np.float32, False)]


@pytest.mark.parametrize("kind,dtype,copies", CASES,
                         ids=[f"{k}-{np.dtype(d).name}" for k, d, _ in CASES])
def test_gray_is_numpys_luma_bit_for_bit(kind, dtype, copies):
    """uint8 and float32 upload as they are (float64 is cast on the host);
    only the strided slice takes the host copy."""
    img = render_scene(3, 40, 64, 16).left[..., ::-1] if kind == "scene" else _image(kind, dtype)
    pipelines._gray255.host_copies = 0
    got = pipelines._gray255(img, "cpu")
    assert _bits_equal(got, _numpy_gray(img))
    assert pipelines._gray255.host_copies == int(copies)
    assert not np.shares_memory(got.numpy(), img)


def test_the_other_luma_order_is_not_the_gray():
    """0.114 B + 0.587 G + 0.299 R (the 3DMST seed's and bgr_to_gray's
    order) rounds differently on non-integer values: the test above can
    tell the two apart."""
    img = _image("rgb", np.float32)
    other = (0.114 * img[..., 2] + 0.587 * img[..., 1]) + 0.299 * img[..., 0]
    assert not np.array_equal(other, _numpy_gray(img))


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the band-streamed SGBM's K1c has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_gray_on_the_card_of_the_rigs_views(cuda, dtype):
    """The benchmark's frames: a 1536x2048 render's BGR views handed over
    as RGB (`bgr[..., ::-1]`). No host copy, the bits of numpy's luma, and
    only the gray left allocated: the uploaded RGB is freed on return."""
    from portbench.traffic.render import render_scene as render_on_card

    sc = render_on_card(11, 1536, 2048, 256, device=cuda)
    pipelines._gray255.host_copies = 0
    for bgr in (sc.left, sc.right):
        if dtype == np.uint8:
            bgr = np.clip(np.round(bgr), 0, 255).astype(dtype)
        view = bgr[..., ::-1]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda)
        got = pipelines._gray255(view, cuda)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(cuda) - before == got.numel() * 4
        assert got.device.type == "cuda" and _bits_equal(got, _numpy_gray(view))
        del got
    assert pipelines._gray255.host_copies == 0


def _band_call(monkeypatch):
    monkeypatch.setattr(pipelines, "SGBM_BAND_THRESHOLD_BYTES", 0)
    sc = render_scene(4, 256, 320, 64)
    cfg = SGBMConfig(min_disp=0, num_disp=64, block_size=5, speckle_window_size=20)
    return sc.left[..., ::-1], sc.right[..., ::-1], cfg


@pytest.mark.cuda
def test_band_streamed_sgbm_on_the_card_keeps_its_map(cuda, monkeypatch):
    """sgbm_pipeline's map on the card equals the one made from numpy's
    gray, uploaded as the port did before the luma moved to the card."""
    left, right, cfg = _band_call(monkeypatch)
    got = pipelines.sgbm_pipeline(left, right, cfg, device=cuda)
    gl, gr = (torch.from_numpy(_numpy_gray(v)).to(cuda) for v in (left, right))
    want = pipelines._filter_speckles(sgbm_disparity_banded(gl, gr, cfg, device=cuda).disparity,
                                      cfg).cpu().numpy()
    assert np.array_equal(got, want)


@pytest.mark.cuda
def test_gray_spans_hold_a_few_launches_a_view(cuda, monkeypatch):
    """A traced call as the benchmark traces it: each `sm.sgbm.gray` span
    holds at most 6 launches (a float32 view's luma: 5 multiplies and
    adds)."""
    from portbench import spans as pspans
    from portbench.tracing import traced

    left, right, cfg = _band_call(monkeypatch)
    pipelines.sgbm_pipeline(left, right, cfg, device=cuda)  # build and warm
    pipelines._gray255.host_copies = 0
    tr = traced(lambda: pipelines.sgbm_pipeline(left, right, cfg, device=cuda), 1,
                lambda _: 1)
    assert pipelines._gray255.host_copies == 0
    spans = [(s, e) for n, s, e in tr.cpu_ops if n == "sm.sgbm.gray"]
    launches = [s for n, s, _ in tr.cpu_ops if n in pspans.LAUNCHES]
    assert len(spans) == 2
    for s, e in spans:
        assert 1 <= sum(s <= t < e for t in launches) <= 6
    assert pspans.attribute(tr).launches["sm.sgbm.gray"] <= 12
