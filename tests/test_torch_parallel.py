"""Port parity: the multi-process layer (parallel/mesh.py, sharded.py,
distributed.py) against the JAX package's ``parallel/`` on the 8-device CPU
mesh of tests/conftest.py, and the public helpers ``is_broadcastable``,
``save_pytree``/``load_pytree`` and the native u8 / Welford staging.

The port's side runs as gloo worlds of 2 and 4 processes on the CPU in
float64 (tests/_torch_parallel_worker.py; each world once per module, each
process its own block), the JAX side in this process on the same numpy
inputs.  The merges agree within 1e-9 absolute
(tests/integration/_distributed_worker.py's bound), the statistics within
rtol 1e-10 (tests/unit/test_parallel.py's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from camera_linearity_tpu import native as jnative  # noqa: E402
from camera_linearity_tpu.parallel import mesh as jmesh  # noqa: E402
from camera_linearity_tpu.parallel import sharded as jsharded  # noqa: E402
from camera_linearity_tpu.utils import general as jgeneral  # noqa: E402
from camera_linearity_tpu_torch import native  # noqa: E402
from camera_linearity_tpu_torch.parallel import distributed as pdist  # noqa
from camera_linearity_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from camera_linearity_tpu_torch.parallel import sharded  # noqa: E402
from camera_linearity_tpu_torch.utils import general  # noqa: E402
from camera_linearity_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_pytree, save_pytree)
from tests._torch_parallel_worker import launch  # noqa: E402

MERGE_ATOL = 1e-9
STATS_RTOL = 1e-10
WORLDS = (2, 4)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _inputs():
    rng = np.random.default_rng(20261017)
    b, n, h, w, c = 4, 3, 16, 24, 3
    x = {"batch_val": rng.uniform(0.05, 0.95, (b, n, h, w, c)),
         "batch_std": rng.uniform(0.001, 0.01, (b, n, h, w, c)),
         "exposures": np.array([0.001, 0.002, 0.004])}
    icrf = np.sort(rng.uniform(0, 1, (256, c)), axis=0)
    icrf[0], icrf[-1] = 0.0, 1.0
    x["icrf"], x["icrf_diff"] = icrf, np.gradient(icrf, 2 / 255, axis=0)
    x["base"], x["diff_base"] = x["icrf"], x["icrf_diff"]
    grid, xb = np.arange(4096) / 4095, np.arange(256) / 255
    x["icrf12"], x["diff12"] = (
        np.stack([np.interp(grid, xb, t[:, ch]) for ch in range(c)], 1)
        for t in (x["base"], x["diff_base"]))
    val = rng.uniform(0, 1, (32, 8, 3))
    std = rng.uniform(0.01, 0.2, (32, 8, 3))
    mask = rng.uniform(size=val.shape) < 0.1
    val[mask] = np.nan
    std[mask] = np.nan
    x.update(val=val, std=std,
             short_v=rng.uniform(0.1, 0.4, (32, 8, 3)),
             long_v=rng.uniform(0.4, 0.9, (32, 8, 3)),
             short_s=rng.uniform(0.005, 0.02, (32, 8, 3)),
             long_s=rng.uniform(0.005, 0.02, (32, 8, 3)))
    return x


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, inputs):
    """Each world's processes' results, by world size, in rank order."""
    out = {}
    for world in WORLDS:
        directory = tmp_path_factory.mktemp(f"world{world}")
        save_pytree(directory / "inputs.pt", inputs)
        launch("sharded", directory, world)
        out[world] = [load_pytree(directory / f"sharded_{r}.pt")
                      for r in range(world)]
    return out


@pytest.fixture(scope="module")
def jmesh8():
    return jmesh.data_pixel_mesh(n_data=2, n_pixel=4)


def _assemble(ranks, key, index=None):
    """The (B, H, W, C) batch from every process's block."""
    b, n, h, w, c = _inputs()["batch_val"].shape
    out = np.full((b, h, w, c), np.nan)
    for r in ranks:
        s0, s1, h0, h1 = r["blocks"]
        block = r[key] if index is None else r[key][index]
        out[s0:s1, h0:h1] = block.numpy()
    assert not np.isnan(out).any()
    return out


def _jax_merge(inputs, mesh, std=True, base=False):
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    bv = jmesh.shard_batch_of_scenes(j["batch_val"], mesh)
    bs = jmesh.shard_batch_of_scenes(j["batch_std"], mesh) if std else None
    if base:
        kw = dict(icrf_base=j["base"],
                  icrf_diff_base=j["diff_base"] if std else None)
        tables = (j["icrf12"], j["diff12"])
    else:
        kw, tables = {}, (j["icrf"], j["icrf_diff"])
    return jsharded.merge_batch_sharded(bv, bs, j["exposures"], *tables,
                                        mesh, **kw)


@pytest.mark.parametrize("world", WORLDS)
def test_merge_batch_sharded_equals_jax(worlds, inputs, jmesh8, world):
    want_v, want_s = _jax_merge(inputs, jmesh8)
    np.testing.assert_allclose(_assemble(worlds[world], "merge", 0),
                               np.asarray(want_v), rtol=0, atol=MERGE_ATOL)
    np.testing.assert_allclose(_assemble(worlds[world], "merge", 1),
                               np.asarray(want_s), rtol=0, atol=MERGE_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_merge_batch_sharded_value_only_equals_jax(worlds, inputs, jmesh8,
                                                   world):
    want_v, want_s = _jax_merge(inputs, jmesh8, std=False)
    assert want_s is None
    np.testing.assert_allclose(_assemble(worlds[world], "merge_value_only"),
                               np.asarray(want_v), rtol=0, atol=MERGE_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_merge_batch_sharded_base_curves_equal_jax(worlds, inputs, jmesh8,
                                                   world):
    want_v, want_s = _jax_merge(inputs, jmesh8, base=True)
    np.testing.assert_allclose(_assemble(worlds[world], "merge_base", 0),
                               np.asarray(want_v), rtol=0, atol=MERGE_ATOL)
    np.testing.assert_allclose(_assemble(worlds[world], "merge_base", 1),
                               np.asarray(want_s), rtol=0, atol=MERGE_ATOL)
    want_vo, _ = _jax_merge(inputs, jmesh8, std=False, base=True)
    np.testing.assert_allclose(
        _assemble(worlds[world], "merge_base_value_only"),
        np.asarray(want_vo), rtol=0, atol=MERGE_ATOL)


def test_merge_batch_sharded_requires_diff_base(inputs):
    """Checked before any collective, as JAX's check precedes its
    shard_map."""
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    with pytest.raises(ValueError, match="icrf_diff_base"):
        sharded.merge_batch_sharded(t["batch_val"], t["batch_std"],
                                    t["exposures"], t["icrf12"],
                                    t["diff12"], None, icrf_base=t["base"])


def _jax_rows(mesh, *arrays):
    spec = NamedSharding(mesh, P("pixel", None, None))
    return [None if a is None else jax.device_put(jnp.asarray(a), spec)
            for a in arrays]


def _same_stats(got, want):
    for k in ("mean", "std", "error"):
        if want[k] is None:
            assert got[k] is None
            continue
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=STATS_RTOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("weighted", [True, False])
def test_dimension_statistics_sharded_equal_jax(worlds, inputs, jmesh8,
                                                world, weighted):
    v, s = _jax_rows(jmesh8, inputs["val"],
                     inputs["std"] if weighted else None)
    want = jsharded.dimension_statistics_sharded(v, s, jmesh8)
    key = "stats" if weighted else "stats_unweighted"
    for r in worlds[world]:
        _same_stats(r[key], want)
    if not weighted:
        np.testing.assert_allclose(worlds[world][0][key]["mean"].numpy(),
                                   np.nanmean(inputs["val"], axis=(0, 1)),
                                   rtol=STATS_RTOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("weighted", [True, False])
def test_pair_stats_sharded_equal_jax(worlds, inputs, jmesh8, world,
                                      weighted):
    names = ("short_v", "long_v", "short_s", "long_s")
    args = _jax_rows(jmesh8, *(inputs[k] if weighted or k.endswith("v")
                               else None for k in names))
    want = jsharded.pair_stats_sharded(*args, 0.5, jmesh8)
    key = "pair" if weighted else "pair_unweighted"
    for r in worlds[world]:
        for got, exp in zip(r[key], want):
            _same_stats(got, exp)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_helpers_give_each_process_its_block(worlds, inputs, world):
    """Scenes over data, rows over pixel, in rank order: each process's
    block is what a PartitionSpec gives the JAX device at its mesh
    position."""
    ranks = worlds[world]
    n_pixel = world // 2
    h = inputs["batch_val"].shape[2]
    for rank, r in enumerate(ranks):
        d, p = divmod(rank, n_pixel)
        band = h // n_pixel
        assert r["blocks"] == [2 * d, 2 * d + 2, p * band, (p + 1) * band]
        assert r["mesh_shape"] == [2, n_pixel]
        assert r["scene_mesh_shape"] == [world, 1]
        assert r["make_mesh_shape"] == [world]
        np.testing.assert_array_equal(    # shard_scene_stack, (1, world)
            r["stack_band"].numpy(),
            inputs["batch_val"][0][:, rank * h // world:
                                   (rank + 1) * h // world])
        np.testing.assert_array_equal(r["replicated"].numpy(), 0.0)
        assert r["global_block_equal"]
        # fetch_local_scenes regathers the rows of the process's scenes
        np.testing.assert_array_equal(
            r["fetched"].numpy(),
            _assemble(ranks, "merge", 0)[2 * d:2 * d + 2])


@pytest.mark.parametrize("world", WORLDS)
def test_scene_blocks_reject_uneven_splits(worlds, world):
    for r in worlds[world]:
        assert "shard evenly" in r["uneven_error"]
        assert "do not make up 6 scenes" in r["batch_error"]
        assert "positions" in r["mesh_error"]


def test_initialize_noop_without_configuration(monkeypatch):
    """With no args and no CL_* env, initialize() is a no-op returning
    False — library users pay nothing for the multi-process capability."""
    for var in ("CL_COORDINATOR_ADDRESS", "CL_NUM_PROCESSES",
                "CL_PROCESS_ID", "CL_LOCAL_DEVICE_IDS"):
        monkeypatch.delenv(var, raising=False)
    assert pdist.initialize(device="cpu") is False
    assert not pdist.is_initialized()
    assert pdist.process_count() == 1 and pdist.process_index() == 0


def test_initialize_needs_every_setting(monkeypatch):
    monkeypatch.setenv("CL_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="no coordinator address, no "
                                         "process id"):
        pdist.initialize(device="cpu")
    assert not pdist.is_initialized()


def test_meshes_need_a_process_group():
    for make in (pmesh.make_mesh, pmesh.data_pixel_mesh, pdist.scene_mesh):
        with pytest.raises(RuntimeError, match="initialize"):
            make(device="cpu")


def test_world_of_one_holds_everything(tmp_path, inputs):
    """One process: every block is the whole array, as JAX's single-process
    mesh gives (tests/unit/test_distributed_helpers.py)."""
    assert pdist.initialize(f"file://{tmp_path / 'rdv'}", 1, 0,
                            device="cpu") is False
    try:
        mesh = pdist.scene_mesh("cpu")
        assert list(mesh.shape) == [1, 1]
        assert pdist.local_scene_block(6, mesh) == slice(0, 6)
        local = inputs["batch_val"]
        block = pdist.global_scene_batch(local, mesh, 4)
        np.testing.assert_array_equal(block.numpy(), local)
        back = pdist.fetch_local_scenes(block[:, 0], mesh, slice(0, 4))
        np.testing.assert_array_equal(back.numpy(), local[:, 0])
        # idempotent
        assert pdist.initialize(f"file://{tmp_path / 'other'}", 2, 1,
                                device="cpu") is False
    finally:
        pdist.shutdown()
    assert not pdist.is_initialized()


# ---------------------------------------------------------------------------
# the public helpers (tests/unit/test_native.py, test_checkpoint.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shapes", [((3, 1), (1, 4)), ((5, 4), (4,)),
                                    ((2, 3), (3, 2)), ((7,), (1, 7, 1)),
                                    ((), (3,))])
def test_is_broadcastable_equals_jax(shapes):
    try:
        want = jgeneral.is_broadcastable(*shapes)
    except ValueError:
        with pytest.raises(ValueError, match="empty"):
            general.is_broadcastable(*shapes)
        return
    assert general.is_broadcastable(*shapes) is want


def test_pytree_roundtrip(tmp_path, rng):
    tree = {"a": rng.normal(size=(4, 5)), "b": np.int32(7)}
    save_pytree(tmp_path / "ckpt", tree)
    back = load_pytree(tmp_path / "ckpt")
    np.testing.assert_allclose(back["a"], tree["a"])
    assert int(back["b"]) == 7


def test_pytree_keeps_nesting_tensors_and_arrays(tmp_path, rng):
    tree = {"t": torch.arange(6.0).reshape(2, 3),
            "nested": [np.arange(3, dtype=np.uint8),
                       (torch.ones(2, dtype=torch.int64), 2.5, "name")],
            "none": None, "flags": np.array([True, False])}
    save_pytree(tmp_path / "sub" / "tree.pt", tree)
    back = load_pytree(tmp_path / "sub" / "tree.pt")
    assert torch.equal(back["t"], tree["t"])
    arr, (ones, f, name) = back["nested"]
    assert isinstance(arr, np.ndarray) and arr.dtype == np.uint8
    np.testing.assert_array_equal(arr, [0, 1, 2])
    assert torch.equal(ones, tree["nested"][1][0])
    assert (f, name) == (2.5, "name") and back["none"] is None
    assert isinstance(back["nested"][1], tuple)
    np.testing.assert_array_equal(back["flags"], [True, False])
    assert not (tmp_path / "sub" / "tree.pt.tmp").exists()


def test_u8_to_f32_equals_jax(rng):
    arr = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    out = native.u8_to_f32(arr, 1.0 / 255)
    np.testing.assert_array_equal(out, jnative.u8_to_f32(arr, 1.0 / 255))
    np.testing.assert_array_equal(
        out, arr.astype(np.float32) * np.float32(1.0 / 255))
    assert out.dtype == np.float32


def test_cfirst_relayout_equals_jax(rng):
    arr = rng.integers(0, 256, (17, 29, 3), dtype=np.uint8)
    out = native.u8_hwc_to_cfirst_f32(arr, 1.0 / 255)
    np.testing.assert_array_equal(
        out, jnative.u8_hwc_to_cfirst_f32(arr, 1.0 / 255))
    assert out.shape == (3, 17 * 29)


def test_host_welford_matches_reference_loop_and_jax(rng):
    frames = rng.integers(0, 256, (25, 11, 13, 3), dtype=np.uint8)
    acc = native.HostWelford((11, 13, 3), scale=1.0 / 255)
    jacc = jnative.HostWelford((11, 13, 3), scale=1.0 / 255)
    for a in (acc, jacc):
        a.update(frames[:16])
        a.update(frames[16:])
    mean, std = acc.finalize()
    jmean, jstd = jacc.finalize()
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(std, jstd)
    omean = np.zeros((11, 13, 3))
    om2 = np.zeros((11, 13, 3))
    for k, f in enumerate(frames, start=1):
        x = f.astype(np.float64) / 255
        delta = x - omean
        omean += delta / k
        om2 += delta * (x - omean)
    ostd = np.sqrt(om2 / (len(frames) - 1)) / np.sqrt(len(frames))
    np.testing.assert_allclose(mean, omean, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(std, ostd, rtol=1e-12, atol=1e-15)
    assert acc.count == 25


def test_host_welford_single_frame(rng):
    acc = native.HostWelford((4, 4, 3), scale=1.0)
    acc.update(rng.integers(0, 2, (4, 4, 3), dtype=np.uint8))
    _, std = acc.finalize()
    assert std is None and acc.count == 1
    with pytest.raises(ValueError, match="float64"):
        native.welford_update_batch_u8(np.zeros((1, 4), np.uint8),
                                       np.zeros(4, np.float32),
                                       np.zeros(4), 1.0, 0)


def test_numpy_fallback_paths(rng, monkeypatch):
    arr = rng.integers(0, 256, (8, 9, 3), dtype=np.uint8)
    native_out = (native.u8_to_f32(arr, 0.5),
                  native.u8_hwc_to_cfirst_f32(arr, 1.0 / 255))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)  # force fallback
    np.testing.assert_array_equal(native.u8_to_f32(arr, 0.5), native_out[0])
    np.testing.assert_array_equal(native.u8_hwc_to_cfirst_f32(arr, 1 / 255),
                                  native_out[1])
    mean = np.zeros(arr.shape)
    m2 = np.zeros(arr.shape)
    count = native.welford_update_batch_u8(arr[None], mean, m2, 1.0, 0)
    assert count == 1
    np.testing.assert_allclose(mean, arr.astype(float))
