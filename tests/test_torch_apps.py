"""The port's CLI (stereomatch_tpu_torch/apps/cli.py) against the JAX
package's CLI on the same files: tests/test_apps.py's `tiny_pair` (48x96,
--max-disparity 16) with a calibration built from numbers (-i: identity
rectification, so both CLIs see the files' pixels), a disparity PNG (-o)
and a point cloud (-p), all ten algorithms with --device cpu. Each engine
is held to the JAX CLI's map as that engine's port test holds it:

  - census: bit-equal (integer costs), and so are its cloud files;
  - bm: the same valid pixels and integer WTA, subpixel within 1e-5 px
    (float luma; tests/test_torch_classic_pipelines.py);
  - hh, sgbm, sgbm3way: 99% of pixels within 1e-4 px (float luma costs);
  - costvolume: 99% within 1e-3 px and every pixel within 0.5 px;
  - mst, sgbm_mst, pm, coupled: 95% of pixels within 0.1 px (XLA's CPU
    FMAs and jax.random's transcendentals; tests/test_torch_mst_flat.py,
    test_torch_patchmatch.py, test_torch_coupled.py).

Measured on the CPU: bm, the three SGBM modes and costvolume within
4.8e-6 px everywhere (80%, 80% and 17% bit for bit); mst, sgbm_mst and
coupled within 0.039 px everywhere; pm 99.5% within 0.1 px.
The float maps are taken where each CLI hands them to save_disparity_png.
"""

import os

import numpy as np
import pytest
import torch

import stereomatch_tpu.io as jio
import stereomatch_tpu_torch.io as tio
from chip_smoke import identity_calibration, write_calibration
from stereomatch_tpu.apps import cli as jcli
from stereomatch_tpu_torch.apps import cli as tcli

ALGORITHMS = ["bm", "sgbm", "hh", "sgbm3way", "census", "costvolume", "mst", "sgbm_mst", "pm",
              "coupled"]
CLOUD = {"bm": ".ply", "hh": ".pcd", "census": ".ply", "costvolume": ".xyz"}


@pytest.fixture(scope="module")
def tiny_pair(tmp_path_factory):
    """tests/test_apps.py's small textured pair, written to disk, and its
    identity calibration as YAML."""
    rng = np.random.default_rng(8)
    h, w, true_d = 48, 96, 6
    base = (rng.random((h, w + true_d, 3)) * 255).astype(np.float32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    left = base[:, :w].astype(np.uint8)
    right = base[:, true_d: true_d + w].astype(np.uint8)
    d = tmp_path_factory.mktemp("cli")
    lp, rp = os.path.join(d, "l.png"), os.path.join(d, "r.png")
    jio.save_image(lp, left)
    jio.save_image(rp, right)
    cal = os.path.join(d, "cal.yml")
    write_calibration(cal, **identity_calibration(h, w))
    return str(d), lp, rp, cal


def _run(main, io_module, monkeypatch, argv):
    """rc and the float map `main` writes as its disparity PNG."""
    maps = []
    save = io_module.save_disparity_png

    def keep(path, disp, max_disp=None):
        maps.append(np.asarray(disp.cpu() if isinstance(disp, torch.Tensor) else disp))
        save(path, disp, max_disp)

    with monkeypatch.context() as m:
        m.setattr(io_module, "save_disparity_png", keep)
        rc = main(argv)
    return rc, maps[0]


def _share(a, b, tol):
    return float(np.mean(np.abs(a - b) <= tol))


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_cli_algorithm_matches_jax_cli(tiny_pair, monkeypatch, alg):
    torch.set_num_threads(1)
    d, lp, rp, cal = tiny_pair
    ext = CLOUD.get(alg, ".ply")
    outs = {}
    for tag, main, io_module, extra in (("t", tcli.main, tio, ["--device", "cpu"]),
                                        ("j", jcli.main, jio, [])):
        png, cloud = os.path.join(d, f"{tag}_{alg}.png"), os.path.join(d, f"{tag}_{alg}{ext}")
        rc, disp = _run(main, io_module, monkeypatch,
                        [lp, rp, "--algorithm", alg, "--max-disparity", "16", "-i", cal,
                         "-o", png, "-p", cloud, *extra])
        assert rc == 0 and os.path.exists(png) and os.path.exists(cloud)
        outs[tag] = (disp, png, cloud)
    got, want = outs["t"][0], outs["j"][0]
    assert got.dtype == np.float32 and got.shape == want.shape == (48, 96)
    assert np.isfinite(got).all()
    if alg == "census":
        np.testing.assert_array_equal(got, want)
        for i in (1, 2):
            with open(outs["t"][i], "rb") as a, open(outs["j"][i], "rb") as b:
                assert a.read() == b.read()
    elif alg == "bm":
        np.testing.assert_array_equal(got >= 0, want >= 0)
        both = (got >= 0) & (want >= 0)
        np.testing.assert_array_equal(np.round(got[both]), np.round(want[both]))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    elif alg in ("sgbm", "hh", "sgbm3way"):
        assert _share(got, want, 1e-4) >= 0.99
    elif alg == "costvolume":
        assert _share(got, want, 1e-3) >= 0.99
        np.testing.assert_allclose(got, want, rtol=0, atol=0.5)
    else:
        assert _share(got, want, 0.1) >= 0.95
    img = tio.load_image(outs["t"][1], gray=True)
    assert img.shape == (48, 96) and img.max() > 0  # something was estimated
    with open(outs["t"][2]) as f:
        text = f.read()
    assert len(text.splitlines()) >= 48 * 96 // 2  # most pixels reproject to a point


def test_cli_rejects_an_even_blocksize(tiny_pair):
    _, lp, rp, _ = tiny_pair
    with pytest.raises(SystemExit) as e:
        tcli.main([lp, rp, "--blocksize", "4", "--device", "cpu"])
    assert e.value.code == 2


def test_cli_cloud_requires_calib(tiny_pair, capsys):
    """-p without -i: the map is written, then rc 1, as the JAX CLI does."""
    d, lp, rp, _ = tiny_pair
    out = os.path.join(d, "nocal.png")
    rc = tcli.main([lp, rp, "--algorithm", "census", "--max-disparity", "16",
                    "--no-rectify", "-o", out, "-p", os.path.join(d, "nocal.ply"),
                    "--device", "cpu"])
    assert rc == 1 and os.path.exists(out)
    assert not os.path.exists(os.path.join(d, "nocal.ply"))
    assert "point cloud needs -i calibration" in capsys.readouterr().err
