"""The port's default device: the card.

With no device given, the entry points resolve ``cuda``; without a card
they raise rather than fall back to the CPU, and with ``device="cpu"`` they
run.  This file imports no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from camera_linearity_tpu_torch import CameraConfig  # noqa: E402
from camera_linearity_tpu_torch.models import calibration as cal  # noqa: E402
from camera_linearity_tpu_torch.models.exposure_series import \
    ExposureSeries  # noqa: E402
from camera_linearity_tpu_torch.models.image_set import ImageSet  # noqa: E402
from camera_linearity_tpu_torch.models import pipeline  # noqa: E402
from camera_linearity_tpu_torch.models import video  # noqa: E402
from camera_linearity_tpu_torch.utils import device as dev  # noqa: E402


def _problem():
    """A one-channel calibration problem as numpy arrays."""
    rng = np.random.default_rng(7)
    exposures = 0.001 * 2.0 ** np.arange(4)
    radiance = rng.uniform(0.01, 0.35, 50)
    dn = np.around(np.clip(radiance[:, None] * exposures / exposures[-1],
                           0, 1) ** (1 / 2.2) * 255).astype(np.int32)
    x = np.linspace(0, 1, 256)
    curves = np.stack([x ** g for g in np.linspace(1.6, 3.0, 8)])
    mean = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean, full_matrices=False)
    return dict(channel_stacks=(dn[None], None, exposures),
                pca_arrays=vt[:3].T[None], mean_icrf_arrays=mean[None],
                config=CameraConfig(num_of_chs=1, datapoints=256))


def _entry_points(tmp_path):
    """Each entry point of the port that takes a device, called with the
    keyword arguments it is given."""
    (tmp_path / "40ms BF a 50x.tif").write_bytes(b"")  # listed, not loaded
    problem = _problem()
    return {
        "ImageSet": lambda **kw: ImageSet("40ms BF a 50x.tif", **kw).device,
        "ImageSet.multiple_from_path": lambda **kw: [
            s.device for s in ImageSet.multiple_from_path(tmp_path, **kw)],
        "ExposureSeries.from_dir_path": lambda **kw: [
            s.device for series in ExposureSeries.from_dir_path(tmp_path,
                                                                **kw)
            for s in series.input_image_sets],
        "calibration": lambda **kw: cal.calibration(
            -1.0, 1.0, **problem, popsize=4, maxiter=2, refine_rounds=0,
            polish_steps=0, **kw)[2],
        "differential_evolution": lambda **kw: cal.differential_evolution(
            lambda x: torch.sum(x ** 2), 2, -np.ones(2), np.ones(2),
            popsize=4, maxiter=2, **kw).x.device,
        "initialize_channel_image_stacks":
            lambda **kw: cal.initialize_channel_image_stacks(
                tmp_path, False, 1, **kw),
        # the video entry points resolve the device before any decode
        "welford_algorithm(backend='device')":
            lambda **kw: video.welford_algorithm(
                tmp_path / "x 5ms.avi", backend="device", **kw),
        "videos_to_exposure_series":
            lambda **kw: pipeline.videos_to_exposure_series(
                [tmp_path / "x 5ms.avi"], **kw),
        "video_to_hdr": lambda **kw: pipeline.video_to_hdr(
            [tmp_path / "x 5ms.avi"], np.eye(256, 3), **kw),
        "batch_video_to_hdr": lambda **kw: pipeline.batch_video_to_hdr(
            {"a": [tmp_path / "x 5ms.avi"]}, np.eye(256, 3), **kw),
    }


def test_default_device_is_the_card():
    assert dev.DEFAULT_DEVICE == torch.device("cuda")
    assert dev.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_resolve_the_card_and_never_fall_back(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, call in _entry_points(tmp_path).items():
        with pytest.raises(RuntimeError, match="device cuda requested"):
            call()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(device="cuda")


def test_entry_points_pick_the_card_when_it_is_there(tmp_path, monkeypatch):
    """The entry points that only record a device report ``cuda`` when a
    card is there (they allocate nothing)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = _entry_points(tmp_path)
    cuda = torch.device("cuda")
    assert calls["ImageSet"]() == cuda
    assert calls["ImageSet.multiple_from_path"]() == [cuda]
    assert calls["ExposureSeries.from_dir_path"]() == [cuda]


def test_entry_points_run_on_the_cpu_when_asked(tmp_path):
    calls = _entry_points(tmp_path)
    cpu = torch.device("cpu")
    assert calls["ImageSet"](device="cpu") == cpu
    assert calls["ImageSet.multiple_from_path"](device="cpu") == [cpu]
    assert calls["ExposureSeries.from_dir_path"](device="cpu") == [cpu]
    assert np.isfinite(calls["calibration"](device="cpu")).all()
    assert calls["differential_evolution"](device="cpu") == cpu


def test_an_image_set_with_a_payload_takes_its_device():
    m = ImageSet("40ms BF a 50x.tif", value=torch.zeros(2, 2, 3))
    assert m.device == torch.device("cpu")


def test_video_entry_points_run_on_the_cpu_when_asked(tmp_path):
    cv2 = pytest.importorskip("cv2")
    frames = np.random.default_rng(0).integers(0, 256, (3, 8, 8, 3),
                                               dtype=np.uint8)
    paths = []
    for ms in (5, 10):
        path = tmp_path / f"s {ms}ms.avi"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"RGBA"),
                                 10, (8, 8))
        for f in frames:
            writer.write(f)
        writer.release()
        paths.append(path)
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)
    cpu = torch.device("cpu")
    assert video.welford_algorithm(paths[0], backend="device",
                                   device="cpu")["mean"].shape == (8, 8, 3)
    series = pipeline.videos_to_exposure_series(paths, device="cpu")
    assert [s.device for s in series.input_image_sets] == [cpu, cpu]
    assert pipeline.video_to_hdr(paths, icrf, device="cpu").device == cpu
    assert pipeline.batch_video_to_hdr({"a": paths}, icrf, device="cpu"
                                       )["a"].device == cpu
