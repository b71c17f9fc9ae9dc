"""The port's state and host boundary: ICRF tables and payloads carried
across from numpy (utils/state.py), the canonical float (utils/device.py),
file IO (utils/io.py) and the configuration (config.py), against the JAX
package where it has a counterpart.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import camera_linearity_tpu as jpkg  # noqa: E402
import camera_linearity_tpu_torch as tpkg  # noqa: E402
from camera_linearity_tpu.models import image_set as jis  # noqa: E402
from camera_linearity_tpu.ops import hdr as jhdr  # noqa: E402
from camera_linearity_tpu.utils import io as jio  # noqa: E402
from camera_linearity_tpu_torch.models import image_set as tis  # noqa: E402
from camera_linearity_tpu_torch.ops import hdr as thdr  # noqa: E402
from camera_linearity_tpu_torch.utils import io as tio  # noqa: E402
from camera_linearity_tpu_torch.utils.device import \
    canonical_float  # noqa: E402
from camera_linearity_tpu_torch.utils.state import (  # noqa: E402
    icrf_tables_from_numpy, measurand_from_numpy)

TOL = dict(rtol=1e-10, atol=1e-12)


def _tables(rng, bits, c=3):
    icrf = np.sort(rng.uniform(0, 1, (bits, c)), axis=0)
    return icrf, np.gradient(icrf, 2 / (bits - 1), axis=0)


# ---------------------------------------------------------------------------
# utils/state.py and utils/device.py
# ---------------------------------------------------------------------------

def test_canonical_float():
    assert canonical_float("cpu") == torch.float64
    assert canonical_float(torch.device("cpu")) == torch.float64
    assert canonical_float("cuda") == torch.float32
    assert canonical_float(torch.device("cuda", 0)) == torch.float32


@pytest.mark.parametrize("dtype", [None, torch.float32])
def test_icrf_tables_from_numpy(rng, dtype):
    icrf, diff = _tables(rng, 4096)
    base, diff_base = _tables(rng, 256)
    out = icrf_tables_from_numpy(icrf, diff, base, diff_base, device="cpu",
                                 dtype=dtype)
    want_dtype = torch.float64 if dtype is None else dtype
    for got, arr in zip(out, (icrf, diff, base, diff_base)):
        assert got.dtype == want_dtype and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), arr.astype(
            got.numpy().dtype))
    t_icrf, t_diff, t_base, t_dbase = icrf_tables_from_numpy(
        icrf[:, 0], diff[:, 0], device="cpu")
    assert t_icrf.shape == (4096,) and t_base is None and t_dbase is None


def test_icrf_tables_from_numpy_rejects(rng):
    icrf, diff = _tables(rng, 256)
    with pytest.raises(ValueError):
        icrf_tables_from_numpy(icrf, diff[:, :2], device="cpu")
    with pytest.raises(ValueError):
        icrf_tables_from_numpy(icrf[None], diff[None], device="cpu")
    with pytest.raises(ValueError):
        icrf_tables_from_numpy(icrf, diff, icrf, None, device="cpu")
    with pytest.raises(ValueError):
        icrf_tables_from_numpy(icrf, diff, icrf[:128], diff[:128],
                               device="cpu")


def test_tables_read_by_the_jax_package_merge_alike(rng, tmp_path):
    """An ICRF file read by the JAX package's reader, carried into the
    port, merges as the JAX package merges with it."""
    icrf = np.sort(rng.uniform(0, 1, (256, 3)), axis=0)
    np.savetxt(tmp_path / "icrf.txt", icrf)
    j_icrf, j_diff = jio.read_icrf_file(tmp_path / "icrf.txt", 256)
    t_icrf, t_diff, _, _ = icrf_tables_from_numpy(j_icrf, j_diff,
                                                  device="cpu")
    val = rng.uniform(0.02, 0.98, (3, 8, 9, 3))
    std = rng.uniform(0.001, 0.02, val.shape)
    exposures = np.array([0.01, 0.02, 0.04])
    m = measurand_from_numpy(val[0], std[0], device="cpu")
    assert m.val.dtype == torch.float64
    got = thdr.merge_hdr(torch.as_tensor(val), torch.as_tensor(std),
                         torch.as_tensor(exposures), t_icrf, t_diff)
    want = jhdr.merge_hdr(jnp.asarray(val), jnp.asarray(std),
                          jnp.asarray(exposures), jnp.asarray(j_icrf),
                          jnp.asarray(j_diff))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_measurand_from_numpy(rng):
    val, std = rng.uniform(0, 1, (4, 5, 3)), rng.uniform(0, 0.1, (4, 5, 3))
    m = measurand_from_numpy(val, std, device="cpu", dtype=torch.float32)
    assert isinstance(m, tpkg.Measurand)
    assert m.val.dtype == m.std.dtype == torch.float32
    np.testing.assert_array_equal(m.std.numpy(), std.astype(np.float32))
    assert measurand_from_numpy(val, device="cpu").std is None
    with pytest.raises(ValueError):
        measurand_from_numpy(val, std[:2], device="cpu")


# ---------------------------------------------------------------------------
# utils/io.py and config.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "5ms BF sample 50x.tif", "12.5ms DF b 10X STD.tif", "flat BF 50x.tif",
    "1000ms df scene 5x.tif", "dark.tif"])
def test_filename_grammar(name):
    tf, jf = tio.features_from_file_name(name), \
        jio.features_from_file_name(name)
    assert tf == jf
    assert tio.path_without_exposure(tio.Path(name), tf) == \
        jio.path_without_exposure(jio.Path(name), jf)
    assert tio.std_path_for(name) == jio.std_path_for(name)
    other = tio.features_from_file_name("7ms " + " ".join(
        name.split()[1:]) if " " in name else name)
    assert tio.is_exposure_match(tf, other) == jio.is_exposure_match(jf,
                                                                     other)
    assert not tio.is_exposure_match(tf, None)


def test_txt_and_icrf_readers(rng, tmp_path):
    icrf = np.sort(rng.uniform(0, 1, (4096, 3)), axis=0)
    np.savetxt(tmp_path / "icrf.txt", icrf)
    for got, want in zip(tio.read_icrf_file(tmp_path / "icrf.txt", 4096),
                         jio.read_icrf_file(tmp_path / "icrf.txt", 4096)):
        np.testing.assert_array_equal(got, want)
    assert tio.read_icrf_file(tmp_path / "icrf.txt", 4096,
                              return_derivative=False)[1] is None
    np.testing.assert_array_equal(
        tio.read_txt_to_array("icrf.txt", tmp_path),
        jio.read_txt_to_array("icrf.txt", tmp_path))


def test_image_loading_through_the_lazy_codec(rng, tmp_path):
    img = rng.integers(0, 256, (6, 7, 3)).astype(np.uint8)
    for name in ("5ms BF a 50x.tif", "10ms BF a 50x.tif"):
        jio.save_image(tmp_path / name, img / 255.0, as_8bit=True)
    jio.save_image(tmp_path / "5ms BF a 50x STD.tif", img / 255.0 * 0.01)
    assert tio.list_image_paths(tmp_path) == jio.list_image_paths(tmp_path)
    for bit64 in (False, True):
        np.testing.assert_array_equal(
            tio.load_image(tmp_path / "5ms BF a 50x.tif", bit64=bit64),
            jio.load_image(tmp_path / "5ms BF a 50x.tif", bit64=bit64))
    assert tio.load_image(tmp_path / "missing.tif") is None

    t_sets = tis.ImageSet.multiple_from_path(tmp_path, device="cpu")
    j_sets = jis.ImageSet.multiple_from_path(tmp_path)
    assert [s.features for s in t_sets] == [s.features for s in j_sets]
    t, j = t_sets[1], j_sets[1]
    t.load_value_image().load_std_image()
    j.load_value_image().load_std_image()
    assert t.val.dtype == torch.float64
    np.testing.assert_allclose(t.val.numpy(), np.asarray(j.val), **TOL)
    np.testing.assert_allclose(t.std.numpy(), np.asarray(j.std), **TOL)


def test_config_is_the_jax_packages():
    t_fields = [(f.name, f.default) for f in
                dataclasses.fields(tpkg.CameraConfig)]
    j_fields = [(f.name, f.default) for f in
                dataclasses.fields(jpkg.CameraConfig)]
    assert t_fields == j_fields
    t = tpkg.CameraConfig(bit_depth=12).replace(dark_threshold=0.05)
    j = jpkg.CameraConfig(bit_depth=12).replace(dark_threshold=0.05)
    assert (t.bits, t.max_dn, t.dark_threshold, t.pixel_size_for("50x")) == \
        (j.bits, j.max_dn, j.dark_threshold, j.pixel_size_for("50x"))
