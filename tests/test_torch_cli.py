"""Port parity: the command line (``python -m camera_linearity_tpu_torch``)
against the JAX package's, command by command, on the same directories
(built as tests/integration/test_cli.py builds them).

The port runs with ``--device cpu`` (float64), the JAX package on the CPU
under x64.  ``merge`` and ``video`` outputs are read back by cv2 and agree
at rtol 1e-10 / atol 1e-12; ``calibrate --strict`` writes the identical
ICRF (both are NumPy); the device ``calibrate`` is checked by its
properties (``torch.Generator`` cannot draw JAX's numbers); ``dorf``'s PCA
files agree up to sign; ``linearity`` logs the same fits.
"""
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from camera_linearity_tpu.__main__ import build_parser as jparser  # noqa
from camera_linearity_tpu.__main__ import main as jmain  # noqa: E402
from camera_linearity_tpu.models import video as jvideo  # noqa: E402
from camera_linearity_tpu.models.image_set import ImageSet  # noqa: E402
from camera_linearity_tpu_torch.__main__ import build_parser  # noqa: E402
from camera_linearity_tpu_torch.__main__ import main as tmain  # noqa: E402
from tests.test_torch_native import write_rgba_avi  # noqa: E402

TOL = dict(rtol=1e-10, atol=1e-12)
CPU = ["--device", "cpu"]


def _read_dir(directory):
    return {p.relative_to(directory).as_posix():
            cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
            for p in sorted(directory.rglob("*.tif"))}


def _same_tiffs(got_dir, want_dir):
    got, want = _read_dir(got_dir), _read_dir(want_dir)
    assert sorted(got) == sorted(want) and want
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_allclose(got[name], want[name], **TOL,
                                   err_msg=name)


def _save(path, val, std=None):
    s = ImageSet(path, value=jnp.asarray(val),
                 std=None if std is None else jnp.asarray(std))
    s.save_8bit(path)


@pytest.fixture
def capture_dir(tmp_path, rng):
    """Two exposure series (8-bit values, float64 STD files), dark frames
    for the exposures at or above dark_threshold, a flat, an ICRF and a
    config.ini naming the dark and flat directories."""
    d = tmp_path / "captures"
    d.mkdir()
    for subject in ("scene", "other"):
        base = rng.uniform(0.2, 0.7, (32, 32, 3))
        for ms in (10, 40, 80):
            val = np.clip(base * (ms / 80), 0, 1)
            _save(d / f"{ms}ms BF {subject} 50x.tif", val,
                  rng.uniform(0.004, 0.01, (32, 32, 3)))
    darks = tmp_path / "darks"
    darks.mkdir()
    for ms in (40, 100):
        dark = rng.uniform(0, 0.01, (32, 32, 3))
        dark[rng.random((32, 32, 3)) < 0.02] = 0.4
        _save(darks / f"{ms}ms BF dark 50x.tif", dark)
    flats = tmp_path / "flats"
    flats.mkdir()
    _save(flats / "BF flat 50x.tif", rng.uniform(0.6, 0.9, (32, 32, 3)),
          np.full((32, 32, 3), 0.004))
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** \
        np.array([1.0, 1.1, 1.2])
    icrf_path = tmp_path / "icrf.txt"
    np.savetxt(icrf_path, icrf)
    ini = tmp_path / "config.ini"
    ini.write_text(f"""
[String data]
dark frames path = {darks}
flat fields path = {flats}
""")
    return d, icrf_path, ini


@pytest.mark.parametrize("corrections", [False, True])
@pytest.mark.parametrize("std", [False, True])
def test_merge_matches_jax(capture_dir, tmp_path, corrections, std):
    d, icrf_path, ini = capture_dir
    common = ["merge", "--images", str(d), "--icrf", str(icrf_path)]
    common += ["--std"] * std
    if corrections:
        common = ["--config", str(ini)] + common
    else:
        common += ["--no-flat"]
    assert jmain(common + ["--out", str(tmp_path / "jax")]) == 0
    assert tmain(CPU + common + ["--out", str(tmp_path / "port")]) == 0
    _same_tiffs(tmp_path / "port", tmp_path / "jax")
    names = sorted(_read_dir(tmp_path / "port"))
    assert len(names) == (4 if std else 2)
    assert all("HDR" in n for n in names)


def _rewrite_workspace(capture_dir, root, std_planar, int16_darks):
    """The captures, darks and flat of ``capture_dir`` (LZW and float64
    TIFFs as cv2 writes them) rewritten as BigTIFF + PackBits + planar
    8-bit values and BigTIFF float64 STD files (planar and uncompressed
    when ``std_planar``, else chunky PackBits); with ``int16_darks`` the
    darks become one-sample int16 MinIsWhite frames whose IMREAD_COLOR
    reading (``255 - (v >> 8)``, repeated) is the dark's first channel.
    Returns (images, icrf, config.ini)."""
    from tests._torch_tiff_writer import build_tiff
    d, icrf_path, _ = capture_dir
    src = d.parent
    rng = np.random.default_rng(5)
    for path in sorted(src.rglob("*.tif")):
        rel = path.relative_to(src)
        if rel.parts[0] not in ("captures", "darks", "flats"):
            continue
        out = root / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        arr = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        rgb = arr[..., ::-1]
        if arr.dtype == np.float64:
            build_tiff(out, ">", rgb, bigtiff=True, rps=7,
                       **(dict(planar=True) if std_planar
                          else dict(compression=32773)))
        elif int16_darks and rel.parts[0] == "darks":
            low = rng.integers(0, 256, arr.shape[:2])
            v = ((255 - arr[..., 0].astype(np.int64)) << 8) | low
            build_tiff(out, "<", v.astype(np.uint16).view(np.int16),
                       rps=5, compression=32773, extra_tags=[(262, 3, [0])])
        else:
            build_tiff(out, "<", rgb, bigtiff=True, planar=True,
                       compression=32773, rps=5)
    ini = root / "config.ini"
    ini.write_text(f"""
[String data]
dark frames path = {root / "darks"}
flat fields path = {root / "flats"}
""")
    return root / "captures", icrf_path, ini


@pytest.mark.parametrize("int16_darks", [False, True],
                         ids=["values", "int16 MinIsWhite darks"])
def test_merge_matches_jax_on_new_tiff_layouts(capture_dir, tmp_path,
                                               int16_darks):
    """``merge --std`` with darks and flat on captures stored as BigTIFF +
    PackBits + planar: the port equals the JAX package (cv2 reading the
    same files); the planar float64 STD files (which cv2 misreads) merge
    to what the chunky ones do."""
    runs = {}
    for std_planar in (False, True):
        images, icrf_path, ini = _rewrite_workspace(
            capture_dir, tmp_path / f"w{int(std_planar)}", std_planar,
            int16_darks)
        common = ["--config", str(ini), "merge", "--images", str(images),
                  "--icrf", str(icrf_path), "--std"]
        out = tmp_path / f"port{int(std_planar)}"
        assert tmain(CPU + common + ["--out", str(out)]) == 0
        runs[std_planar] = out
        if not std_planar:
            assert jmain(common + ["--out", str(tmp_path / "jax")]) == 0
    _same_tiffs(runs[False], tmp_path / "jax")
    got, want = _read_dir(runs[True]), _read_dir(runs[False])
    assert sorted(got) == sorted(want) and len(want) == 4
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_merge_matches_jax_on_jpeg_tiffs(capture_dir, tmp_path):
    """``merge --std`` with darks and flat on captures, darks and flat
    rewritten as JPEG-compressed YCbCr 4:2:0 TIFFs (quality 90, 16 x 16
    tiles; the STD files stay uncompressed float64): the port equals the
    JAX package, whose cv2 reads the same files."""
    from tests._torch_tiff_writer import build_tiff
    d, icrf_path, _ = capture_dir
    src, root = d.parent, tmp_path / "jpeg"
    for path in sorted(src.rglob("*.tif")):
        rel = path.relative_to(src)
        if rel.parts[0] not in ("captures", "darks", "flats"):
            continue
        out = root / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        arr = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if arr.dtype == np.float64:
            build_tiff(out, "<", arr[..., ::-1], rps=7)
        else:
            build_tiff(out, "<", arr[..., ::-1], compression=7,
                       ycbcr=(2, 2), quality=90, tile=(16, 16))
    ini = root / "config.ini"
    ini.write_text(f"""
[String data]
dark frames path = {root / "darks"}
flat fields path = {root / "flats"}
""")
    common = ["--config", str(ini), "merge", "--images",
              str(root / "captures"), "--icrf", str(icrf_path), "--std"]
    assert jmain(common + ["--out", str(tmp_path / "jax")]) == 0
    assert tmain(CPU + common + ["--out", str(tmp_path / "port")]) == 0
    _same_tiffs(tmp_path / "port", tmp_path / "jax")
    assert len(_read_dir(tmp_path / "port")) == 4


def test_merge_stage_times_and_default_out(capture_dir):
    from camera_linearity_tpu_torch.utils import observability as obs
    d, icrf_path, ini = capture_dir
    obs.reset_stage_times()
    assert tmain(CPU + ["--config", str(ini), "merge", "--images", str(d),
                        "--icrf", str(icrf_path), "--std"]) == 0
    assert sorted(obs.stage_times.snapshot()) == ["merge_s", "read_s",
                                                  "write_s"]
    assert len(list((d / "hdr").glob("* HDR STD.tif"))) == 2


def test_merge_needs_a_card_by_default(capture_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    d, icrf_path, _ = capture_dir
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain(["merge", "--images", str(d), "--icrf", str(icrf_path)])


def _calibration_workspace(tmp_path, rng):
    """A synthetic gamma stack, PCA files and a config.ini
    (tests/integration/test_cli.py:52-87)."""
    images = tmp_path / "images"
    images.mkdir()
    x = np.linspace(0, 1, 256)
    curves = np.stack([x ** g for g in np.linspace(1.8, 2.6, 15)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    for ch in "bgr":
        np.savetxt(tmp_path / f"pca_{ch}.txt", vt[:3].T)
        np.savetxt(tmp_path / f"mean_{ch}.txt", mean_icrf)
    radiance = rng.uniform(0.05, 0.4, (24, 24, 3))
    for ms in (2, 4, 8, 16):
        lin = np.clip(radiance * (ms / 16), 0, 1)
        dn = np.around(np.clip(lin ** (1 / 2.2), 0, 1) * 255) / 255
        _save(images / f"{ms}ms BF cal 50x.tif", dn)
    ini = tmp_path / "config.ini"
    ini.write_text("""
[Integer data]
channels = 3
bit depth = 8
final datapoints = 256
number of principal components = 3

[String data]
principal components = pca_b.txt,pca_g.txt,pca_r.txt
mean ICRFs = mean_b.txt,mean_g.txt,mean_r.txt
""")
    return ini, images


def test_calibrate_strict_is_identical(tmp_path, rng):
    ini, images = _calibration_workspace(tmp_path, rng)
    args = ["--config", str(ini), "calibrate", "--images", str(images),
            "--spacing", "2", "--maxiter", "2", "--strict", "--out"]
    assert jmain(args + [str(tmp_path / "jax.txt")]) == 0
    assert tmain(CPU + args + [str(tmp_path / "port.txt")]) == 0
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "port.txt"),
                                  np.loadtxt(tmp_path / "jax.txt"))


def test_calibrate_hybrid(tmp_path, rng, port_log):
    """--hybrid: the port's device solve on the CPU seeds the strict
    float64 polish."""
    ini, images = _calibration_workspace(tmp_path, rng)
    out = tmp_path / "hybrid.txt"
    assert tmain(CPU + ["--config", str(ini), "calibrate", "--images",
                        str(images), "--out", str(out), "--spacing", "2",
                        "--maxiter", "5", "--hybrid", "--strict-maxiter",
                        "2"]) == 0
    solved = np.loadtxt(out)
    assert solved.shape == (256, 3)
    assert solved.min() >= 0.0 and solved.max() <= 1.0
    e0, e1 = (np.asarray(r.args[0]) for r in port_log
              if r.msg.startswith(("initial energies", "final energies")))
    assert np.all(e1 <= e0)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture
def port_log():
    from camera_linearity_tpu_torch.utils.observability import get_logger
    logger = get_logger()  # configured before the handler joins it
    handler = _Records()
    logger.addHandler(handler)
    yield handler.records
    logger.removeHandler(handler)


def test_calibrate_on_the_device(tmp_path, rng, port_log):
    ini, images = _calibration_workspace(tmp_path, rng)
    out = tmp_path / "icrf_solved.txt"
    assert tmain(CPU + ["--config", str(ini), "calibrate", "--images",
                        str(images), "--out", str(out), "--spacing", "2",
                        "--maxiter", "10"]) == 0
    solved = np.loadtxt(out)
    assert solved.shape == (256, 3)
    assert np.all(np.diff(solved, axis=0) >= -1e-9)
    base = np.loadtxt(tmp_path / "icrf_solved_base.txt")
    assert base.shape == (256, 3)
    np.testing.assert_allclose(base[0], 0.0, atol=1e-12)
    energies = {r.msg.split(":")[0]: np.asarray(r.args[0])
                for r in port_log if "energies" in r.msg}
    assert np.all(energies["final energies"]
                  <= energies["initial energies"])


def test_video_matches_jax(tmp_path):
    frames = np.random.default_rng(3).integers(40, 220, (9, 24, 40, 3),
                                               np.uint8)
    dirs = {pkg: tmp_path / pkg for pkg in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
        write_rgba_avi(d / "scene 5ms.avi", frames)
        write_rgba_avi(d / "scene 10ms.avi", frames[::-1] // 2)
    assert jmain(["video", "--videos", str(dirs["jax"])]) == 0
    assert tmain(CPU + ["video", "--videos", str(dirs["port"])]) == 0
    _same_tiffs(dirs["port"], dirs["jax"])
    assert sorted(_read_dir(dirs["port"])) == [
        "mean/scene 10ms.tif", "mean/scene 5ms.tif",
        "std/scene 10ms STD.tif", "std/scene 5ms STD.tif"]


def test_video_pooled_mode(tmp_path):
    """The repair of the JAX CLI's ``--separately`` (store_true with
    default True): the port's ``--no-separately`` reaches the pooled mode
    of ``process_directory``, which the JAX CLI cannot."""
    frames = np.random.default_rng(4).integers(40, 220, (5, 24, 40, 3),
                                               np.uint8)
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        for k in range(2):
            write_rgba_avi(tmp_path / pkg / f"v{k} 5ms.avi", frames + k)
    assert jparser().parse_args(["video", "--videos", "x"]).separately
    assert jparser().parse_args(["video", "--videos", "x",
                                 "--separately"]).separately
    with pytest.raises(SystemExit):
        jparser().parse_args(["video", "--videos", "x", "--no-separately"])
    assert build_parser().parse_args(["video", "--videos", "x"]).separately
    assert not build_parser().parse_args(
        ["video", "--videos", "x", "--no-separately"]).separately
    jvideo.process_directory(tmp_path / "jax", separately=False,
                             decoder="cv2")
    assert tmain(CPU + ["video", "--videos", str(tmp_path / "port"),
                        "--no-separately"]) == 0
    _same_tiffs(tmp_path / "port", tmp_path / "jax")
    assert sorted(_read_dir(tmp_path / "port")) == ["total_mean.tif",
                                                    "total_std.tif"]


def test_dorf_matches_jax_up_to_sign(tmp_path):
    x = np.linspace(0, 1, 64)
    lines = []
    for name, g in [("aRed", 2.0), ("aGreen", 2.2), ("aBlue", 2.4),
                    ("bRed", 2.1), ("bGreen", 2.3), ("bBlue", 2.5),
                    ("cRed", 1.9), ("cGreen", 2.0), ("cBlue", 2.6)]:
        lines += [name, "t", "i", "I =", " ".join(f"{v:.5f}" for v in x),
                  " ".join(f"{v:.5f}" for v in x ** g)]
    ini = tmp_path / "config.ini"
    ini.write_text("""
[Integer data]
channels = 3
bit depth = 8
final datapoints = 64
original DoRF datapoints = 64
number of principal components = 2

[String data]
source DoRF data = dorfCurves.txt
ICRFs = icrf_b.txt,icrf_g.txt,icrf_r.txt
mean ICRFs = mean_b.txt,mean_g.txt,mean_r.txt
principal components = pca_b.txt,pca_g.txt,pca_r.txt
""")
    for pkg, main in (("jax", jmain), ("port", tmain)):
        data = tmp_path / pkg
        data.mkdir()
        (data / "dorfCurves.txt").write_text("\n".join(lines) + "\n")
        assert main(CPU * (pkg == "port") + ["--config", str(ini), "dorf",
                                             "--data", str(data)]) == 0
    for ch in "bgr":
        for stem in ("icrf", "mean"):
            np.testing.assert_allclose(
                np.loadtxt(tmp_path / "port" / f"{stem}_{ch}.txt"),
                np.loadtxt(tmp_path / "jax" / f"{stem}_{ch}.txt"), **TOL)
        got = np.loadtxt(tmp_path / "port" / f"pca_{ch}.txt")
        want = np.loadtxt(tmp_path / "jax" / f"pca_{ch}.txt")
        assert got.shape == want.shape == (64, 2)
        signs = np.sign(np.sum(got * want, axis=0))
        np.testing.assert_allclose(got * signs, want, rtol=1e-8, atol=1e-10)


def test_linearity_logs_the_jax_fits(capture_dir, tmp_path, port_log):
    pytest.importorskip("matplotlib")
    d, icrf_path, _ = capture_dir
    from camera_linearity_tpu.utils.observability import get_logger
    jlogger = get_logger()
    handler = _Records()
    jlogger.addHandler(handler)
    try:
        for pkg, main in (("jax", jmain), ("port", tmain)):
            (tmp_path / pkg).mkdir()
            assert main(CPU * (pkg == "port") + [
                "linearity", "--images", str(d), "--icrf", str(icrf_path),
                "--std", "--out", str(tmp_path / pkg)]) == 0
    finally:
        jlogger.removeHandler(handler)

    def fits(records):
        return [r.args for r in records if "ODR fit" in r.msg]
    got, want = fits(port_log), fits(handler.records)
    assert len(got) == len(want) == 2 * 2 * 3  # series x kind x channel
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        np.testing.assert_allclose(g[3:], w[3:], **TOL)
    assert (tmp_path / "port" / "linearity_relative_1.png").exists()


def test_doctor_prints_its_lines(tmp_path, capsys):
    path = tmp_path / "v 5ms.avi"
    write_rgba_avi(path, np.zeros((3, 24, 40, 3), np.uint8))
    assert tmain(CPU + ["doctor", "--video", str(path)]) == 0
    out = capsys.readouterr().out
    for line in ("camera_linearity_tpu_torch", "torch ", "TF32",
                 "native staging library: built",
                 "native TIFF codec: built; LZW decode",
                 "device dispatch+matmul round trip", "decode (native)",
                 "decode (cv2)"):
        assert line in out, line


@pytest.mark.parametrize("flag", [["--coordinator", "localhost:1234"],
                                  ["--num-processes", "2"],
                                  ["--process-id", "0"], "CL_NUM_PROCESSES"])
def test_multi_process_options_raise(tmp_path, monkeypatch, flag):
    """One setting alone is not a multi-process run: the others are named,
    before any command runs."""
    args = CPU + ["dorf", "--data", str(tmp_path)]
    if isinstance(flag, str):
        monkeypatch.setenv(flag, "2")
    else:
        args = flag + args
    with pytest.raises(ValueError, match="a multi-process run needs all "
                                         "three"):
        tmain(args)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("by", ["flags", "env"])
def test_multi_process_options_join_a_world_of_one(tmp_path, monkeypatch,
                                                   capsys, by):
    """The flags (or CL_*) join a process group for the command and leave
    it when the command ends."""
    wiring = ["--coordinator", f"file://{tmp_path / 'rendezvous'}",
              "--num-processes", "1", "--process-id", "0"]
    if by == "env":
        for name, value in zip(("CL_COORDINATOR_ADDRESS",
                                "CL_NUM_PROCESSES", "CL_PROCESS_ID"),
                               wiring[1::2]):
            monkeypatch.setenv(name, value)
        wiring = []
    seen = {}
    monkeypatch.setattr(
        "camera_linearity_tpu_torch.__main__.cmd_dorf",
        lambda args: seen.update(size=torch.distributed.get_world_size(),
                                 backend=torch.distributed.get_backend())
        or 0)
    assert tmain(wiring + CPU + ["dorf"]) == 0
    assert seen == {"size": 1, "backend": "gloo"}
    assert not torch.distributed.is_initialized()
