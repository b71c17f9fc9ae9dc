"""Port parity: the file layer (utils/io.py, ImageSet's saves, the dark and
flat calibration helpers, the linearity fits) against the JAX package.

Both packages save the same images (numpy, from the per-test ``rng``):
the port through its own TIFF codec, the JAX package through cv2; cv2
reads both back, and the arrays agree at rtol 1e-10 / atol 1e-12 (the
tolerance of tests/test_torch_exposure_series.py).  The port reads its
TIFFs with cv2 absent, and says what needs cv2 where it does.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

import camera_linearity_tpu as jpkg  # noqa: E402
import camera_linearity_tpu_torch as tpkg  # noqa: E402
from camera_linearity_tpu.models import image_set as jis  # noqa: E402
from camera_linearity_tpu.utils import io as jio  # noqa: E402
from camera_linearity_tpu.utils import visualization as jviz  # noqa: E402
from camera_linearity_tpu_torch.models import image_set as tis  # noqa: E402
from camera_linearity_tpu_torch.utils import io as tio  # noqa: E402
from camera_linearity_tpu_torch.utils import \
    visualization as tviz  # noqa: E402

TOL = dict(rtol=1e-10, atol=1e-12)
H, W, C = 24, 20, 3


def _sets(name, val, std, cfg=tpkg.DEFAULT_CONFIG):
    """The same image as a port ImageSet (CPU, float64) and a JAX one."""
    t = tis.ImageSet(name, config=cfg, device="cpu",
                     measurand=tpkg.Measurand(
                         torch.as_tensor(val),
                         None if std is None else torch.as_tensor(std)))
    j = jis.ImageSet(name, config=cfg,
                     measurand=jpkg.Measurand(
                         jnp.asarray(val),
                         None if std is None else jnp.asarray(std)))
    return t, j


def _read_dir(directory):
    """{file name: cv2.imread(IMREAD_UNCHANGED)} of every tif in it."""
    return {p.name: cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
            for p in sorted(directory.rglob("*.tif"))}


def _same_files(got_dir, want_dir):
    got, want = _read_dir(got_dir), _read_dir(want_dir)
    assert sorted(got) == sorted(want) and got
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_allclose(got[name], want[name], **TOL)


@pytest.mark.parametrize("separate_channels", [False, True])
@pytest.mark.parametrize("is_hdr", [False, True])
@pytest.mark.parametrize("with_std", [False, True])
def test_save_64bit_matches_jax(tmp_path, rng, separate_channels, is_hdr,
                                with_std):
    val = rng.uniform(0, 3, (H, W, C))
    std = rng.uniform(0, 0.1, (H, W, C)) if with_std else None
    t, j = _sets("20ms BF sample 50x.tif", val, std)
    t.save_64bit(tmp_path / "port" / "out.tif", is_hdr=is_hdr,
                 separate_channels=separate_channels)
    j.save_64bit(tmp_path / "jax" / "out.tif", is_hdr=is_hdr,
                 separate_channels=separate_channels)
    _same_files(tmp_path / "port", tmp_path / "jax")


def test_save_64bit_default_path(tmp_path, rng):
    val = rng.uniform(0, 1, (H, W, C))
    for pkg in ("port", "jax"):
        (tmp_path / pkg).mkdir()
    t, _ = _sets(tmp_path / "port" / "5ms BF a 5x.tif", val, None)
    _, j = _sets(tmp_path / "jax" / "5ms BF a 5x.tif", val, None)
    t.save_64bit()
    j.save_64bit()
    assert (tmp_path / "port" / "64bit" / "5ms BF a 5x.tif").exists()
    _same_files(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("force_8_bit", [False, True])
@pytest.mark.parametrize("peak", [0.9, 2.5])
def test_save_8bit_matches_jax(tmp_path, rng, force_8_bit, peak):
    val = rng.uniform(0, peak, (H, W, C))
    std = rng.uniform(0, 0.05, (H, W, C))
    t, j = _sets("8ms BF s 10x.tif", val, std)
    t.save_8bit(tmp_path / "port", force_8_bit=force_8_bit)
    j.save_8bit(tmp_path / "jax", force_8_bit=force_8_bit)
    _same_files(tmp_path / "port", tmp_path / "jax")
    # the 8-bit value file loads back as the JAX package loads it
    for bit64 in (False, True):
        got = tio.load_image(tmp_path / "port" / "8ms BF s 10x.tif", bit64)
        want = jio.load_image(tmp_path / "jax" / "8ms BF s 10x.tif", bit64)
        np.testing.assert_array_equal(got, want)


def _frames(directory, exposures_ms, rng, name="dark", with_std=True):
    """8-bit captures of ``exposures_ms`` (written by cv2), with float64
    STD files."""
    directory.mkdir(parents=True)
    for ms in exposures_ms:
        dn = rng.integers(0, 40, (H, W, C), np.uint8)
        cv2.imwrite(str(directory / f"{ms}ms BF {name} 50x.tif"), dn)
        if with_std:
            cv2.imwrite(str(directory / f"{ms}ms BF {name} 50x STD.tif"),
                        rng.uniform(0.001, 0.01, (H, W, C)))


def test_image_set_loads_like_jax(tmp_path, rng):
    _frames(tmp_path / "d", (5, 10), rng)
    for ms in (5, 10):
        path = tmp_path / "d" / f"{ms}ms BF dark 50x.tif"
        t = tis.ImageSet(path, device="cpu").load_value_image()
        t.load_std_image()
        j = jis.ImageSet(path).load_value_image()
        j.load_std_image()
        np.testing.assert_array_equal(t.val.numpy(), np.asarray(j.val))
        np.testing.assert_array_equal(t.std.numpy(), np.asarray(j.std))


def test_calibrate_dark_frames_matches_jax(tmp_path, rng):
    _frames(tmp_path / "raw darks", (50, 100, 200), rng)
    outs = {}
    for pkg, fn, kw in (("port", tis.calibrate_dark_frames,
                         dict(device="cpu")),
                        ("jax", jis.calibrate_dark_frames, {})):
        cfg = tpkg.CameraConfig(
            uncalibrated_dark_path=str(tmp_path / "raw darks"),
            default_dark_path=str(tmp_path / pkg))
        outs[pkg] = fn(config=cfg, **kw)
    _same_files(tmp_path / "port", tmp_path / "jax")
    assert len(outs["port"]) == len(outs["jax"]) == 3
    for t, j in zip(outs["port"], outs["jax"]):
        assert t.features == j.features
        np.testing.assert_allclose(t.val.numpy(), np.asarray(j.val), **TOL)
        np.testing.assert_allclose(t.std.numpy(), np.asarray(j.std), **TOL)


def test_calibrate_flats_matches_jax(tmp_path, rng):
    _frames(tmp_path / "darks", (30, 60), rng)
    _frames(tmp_path / "raw flats", (15,), rng, name="flat")
    for pkg, fn, kw in (("port", tis.calibrate_flats, dict(device="cpu")),
                        ("jax", jis.calibrate_flats, {})):
        cfg = tpkg.CameraConfig(
            default_dark_path=str(tmp_path / "darks"),
            uncalibrated_flat_path=str(tmp_path / "raw flats"),
            default_flat_path=str(tmp_path / pkg))
        out = fn(config=cfg, **kw)
        assert len(out) == 1
    _same_files(tmp_path / "port", tmp_path / "jax")


def test_tiffs_need_no_cv2(tmp_path, rng, monkeypatch):
    """With cv2 unimportable the port still reads and writes TIFFs; a PNG
    and ``show_image`` say they need cv2."""
    val = rng.uniform(0, 1, (H, W, C))
    t, _ = _sets("5ms BF a 5x.tif", val, None)
    t.save_64bit(tmp_path / "a.tif")
    monkeypatch.setitem(sys.modules, "cv2", None)
    t.save_8bit(tmp_path / "b.tif")
    np.testing.assert_array_equal(tio.load_image(tmp_path / "a.tif", True),
                                  val)
    np.testing.assert_array_equal(
        tio.load_image(tmp_path / "b.tif"), np.around(val * 255) / 255)
    with pytest.raises(ImportError, match="other than TIFF"):
        tio.load_image(tmp_path / "c.png")
    with pytest.raises(ImportError, match="show_image needs OpenCV"):
        t.show_image()
    assert tio.load_image(tmp_path / "missing.tif") is None


def _stats(rng, k=6):
    ratios = np.sort(rng.uniform(0.1, 0.9, k))
    means = 0.01 + 0.02 * ratios[:, None] + rng.normal(0, 1e-3, (k, C))
    stds = rng.uniform(1e-3, 5e-3, (k, C))
    stds[0, 1] = 0.0  # a zero std takes the 1e-12 floor in both
    return {"ratios": ratios, "means": means, "stds": stds,
            "errors": rng.uniform(1e-4, 1e-3, (k, C))}


def test_linearity_fits_match_jax(tmp_path, rng):
    stats = _stats(rng)
    want = jviz.create_linearity_plots(stats, tmp_path / "j.png", True,
                                       "relative difference", "R")
    got = tviz.create_linearity_plots(stats, tmp_path / "t.png", True,
                                      "relative difference", "R")
    assert (tmp_path / "t.png").exists()
    assert got.keys() == want.keys() == {"b", "g", "r"}
    for cc in want:
        for key in ("beta", "sd_beta"):
            np.testing.assert_allclose(got[cc][key], want[cc][key], **TOL)
    fits = tviz.linearity_fits(stats)
    assert fits == got
    assert tviz.create_linearity_plots(stats, tmp_path / "n.png", False,
                                       "y", "R") == {}
    assert tviz.linearity_fits({**stats, "ratios": stats["ratios"][:1]}) \
        == {}
