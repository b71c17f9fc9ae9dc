"""Worker processes for the port's multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_distributed.py).

    python -m tests._torch_parallel_worker CASE DIR

runs one process of a gloo world on the CPU, wired by the ``CL_*``
environment that :func:`launch` sets, as a user's processes would be.  Each
case reads its inputs from ``DIR`` (written by the parent test) and writes
``DIR/<case>_<rank>.pt`` with ``utils/checkpoint.py::save_pytree``; the
parent holds them to the JAX package and to the single-process port.  The
workers import torch and the port, never JAX.
"""
import contextlib
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# a worker group that has not finished by then is killed, and its test fails
GROUP_TIMEOUT_S = 180
INIT_TIMEOUT_S = 60


def launch(case: str, directory: Path, world: int, argv=None):
    """Run ``world`` processes of ``case`` (or of ``argv``, a command line
    run with the ``CL_*`` environment) and return their outputs; a process
    that fails, or a group that outlasts GROUP_TIMEOUT_S, fails."""
    argv = argv or [sys.executable, "-m", "tests._torch_parallel_worker",
                    case, str(directory)]
    rendezvous = directory / f"{case}.rendezvous"
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        env.update({
            "CL_COORDINATOR_ADDRESS": f"file://{rendezvous}",
            "CL_NUM_PROCESSES": str(world), "CL_PROCESS_ID": str(rank),
            "OMP_NUM_THREADS": "1",
            "PYTHONPATH": str(REPO) + os.pathsep + env.get("PYTHONPATH", ""),
        })
        procs.append(subprocess.Popen(argv, env=env, cwd=REPO,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GROUP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{case} process {rank} failed:\n{out}"
    return outs


@contextlib.contextmanager
def world_of_one(directory: Path):
    """This process as a gloo world of one, for the length of the block."""
    from camera_linearity_tpu_torch.parallel import distributed as pdist
    pdist.initialize(f"file://{directory / 'rendezvous'}", 1, 0,
                     device="cpu", timeout_s=INIT_TIMEOUT_S)
    try:
        yield
    finally:
        pdist.shutdown()


def _cpu(x):
    import torch
    return None if x is None else torch.as_tensor(x)


def _raises(fn, error=ValueError) -> str:
    """The message of the ``error`` that ``fn()`` raises, "" if none."""
    try:
        fn()
    except error as exc:
        return str(exc)
    return ""


def case_sharded(directory: Path, rank: int, world: int) -> dict:
    """parallel/: the merge, the statistics and the mesh helpers."""
    import torch

    from camera_linearity_tpu_torch.parallel import distributed as pdist
    from camera_linearity_tpu_torch.parallel import mesh as pmesh
    from camera_linearity_tpu_torch.parallel import sharded
    from camera_linearity_tpu_torch.utils.checkpoint import load_pytree

    x = load_pytree(directory / "inputs.pt")
    t = {k: _cpu(v) for k, v in x.items()}
    out = {}

    mesh = pmesh.data_pixel_mesh(n_data=2, device="cpu")
    bv = pmesh.shard_batch_of_scenes(x["batch_val"], mesh)
    bs = pmesh.shard_batch_of_scenes(t["batch_std"], mesh)
    scenes = pdist.local_scene_block(bv.shape[0] * 2, mesh)
    rows = pmesh.block_of(x["batch_val"].shape[2], mesh, "pixel", "rows")
    out["blocks"] = [scenes.start, scenes.stop, rows.start, rows.stop]
    args = (t["exposures"], t["icrf"], t["icrf_diff"], mesh)
    out["merge"] = sharded.merge_batch_sharded(bv, bs, *args)
    out["merge_value_only"] = sharded.merge_batch_sharded(bv, None, *args)[0]
    args12 = (t["exposures"], t["icrf12"], t["diff12"], mesh)
    out["merge_base"] = sharded.merge_batch_sharded(
        bv, bs, *args12, icrf_base=t["base"], icrf_diff_base=t["diff_base"])
    out["merge_base_value_only"] = sharded.merge_batch_sharded(
        bv, None, *args12, icrf_base=t["base"])[0]

    # statistics: rows over every process
    flat = pmesh.data_pixel_mesh(device="cpu")
    band = pmesh.block_of(x["val"].shape[0], flat, "pixel", "rows")
    local = {k: t[k][band] for k in ("val", "std", "short_v", "long_v",
                                     "short_s", "long_s")}
    out["stats"] = sharded.dimension_statistics_sharded(
        local["val"], local["std"], flat)
    out["stats_unweighted"] = sharded.dimension_statistics_sharded(
        local["val"], None, flat)
    out["pair"] = sharded.pair_stats_sharded(
        local["short_v"], local["long_v"], local["short_s"],
        local["long_s"], 0.5, flat)
    out["pair_unweighted"] = sharded.pair_stats_sharded(
        local["short_v"], local["long_v"], None, None, 0.5, flat)

    # the mesh helpers
    out["mesh_shape"] = list(mesh.shape)
    out["scene_mesh_shape"] = list(pdist.scene_mesh("cpu").shape)
    out["make_mesh_shape"] = list(pmesh.make_mesh(device="cpu").shape)
    out["stack_band"] = pmesh.shard_scene_stack(x["batch_val"][0], flat)
    out["replicated"] = pmesh.replicate(torch.full((3,), float(rank)), mesh)
    n_scenes = x["batch_val"].shape[0]
    local_batch = x["batch_val"][scenes]
    block = pdist.global_scene_batch(local_batch, mesh, n_scenes)
    out["global_block_equal"] = bool(torch.equal(block, bv))
    out["fetched"] = pdist.fetch_local_scenes(out["merge"][0], mesh, scenes)
    out["uneven_error"] = _raises(lambda: pdist.local_scene_block(3, mesh))
    out["batch_error"] = _raises(lambda: pdist.global_scene_batch(
        local_batch, mesh, n_scenes + 2))
    out["mesh_error"] = _raises(lambda: pmesh.make_mesh((world + 1,),
                                                        device="cpu"))
    return out


def case_pipeline(directory: Path, rank: int, world: int) -> dict:
    """models/pipeline.py: batch_video_to_hdr routed to the distributed
    path, in full float width, with an f16 std on the wire, and with the
    calibration leg."""
    import numpy as np

    from camera_linearity_tpu_torch.models import pipeline as tpipe
    from camera_linearity_tpu_torch.utils.checkpoint import load_pytree

    x = load_pytree(directory / "pipeline_inputs.pt")
    scenes = {name: [Path(p) for p in paths]
              for name, paths in x["scenes"]}

    solved = {}
    maybe = tpipe._maybe_calibrate_distributed

    def recording(*args, **kwargs):
        solved["tables"] = maybe(*args, **kwargs)
        return solved["tables"]
    tpipe._maybe_calibrate_distributed = recording

    out = {}
    for key, kw in (("", {}), ("f16_", {"wire_std": "f16"}),
                    ("cal_", {"calibrate": x["spec"]})):
        res = tpipe.batch_video_to_hdr(scenes, x["icrf"], device="cpu", **kw)
        out[key + "names"] = list(res)
        out[key + "val"] = [r.measurand.val for r in res.values()]
        out[key + "std"] = [r.measurand.std for r in res.values()]
    out["tables"] = list(solved["tables"])
    out["finite"] = bool(np.isfinite(out["tables"][0].numpy()).all())
    return out


def case_de(directory: Path, rank: int, world: int) -> dict:
    """models/calibration.py: the population-sharded solver and
    calibration, on the port's generators or on replayed draws."""
    from camera_linearity_tpu_torch import CameraConfig
    from camera_linearity_tpu_torch.models import calibration as tcal
    from camera_linearity_tpu_torch.parallel import mesh as pmesh
    from camera_linearity_tpu_torch.utils.checkpoint import load_pytree

    x = load_pytree(directory / "de_inputs.pt")
    mesh = pmesh.make_mesh(device="cpu")
    out = {}
    draw = tcal.draw_generation
    for name, case in x["solves"].items():
        if "draws" in case:
            replay = iter(case["draws"])
            tcal.draw_generation = lambda *a, **k: tcal.Draws(*next(replay))
        energy = tcal._make_population_energy(True, "soft", 5, 250, 256,
                                              False)
        # a checkpoint path of each process's own: only rank 0's holds one
        kw = dict(case["kw"], checkpoint_path=directory / f"{name}_{rank}"
                  ".ckpt") if case.get("resume") else case["kw"]
        res, frozen = tcal.differential_evolution_batched(
            energy, tuple(_cpu(v) for v in case["data"]), case["c"],
            case["d"], case["lower"], case["upper"], mesh=mesh,
            pop_axis="data", device="cpu", **kw)
        tcal.draw_generation = draw
        out[name] = {"population": res.population, "energies": res.energies,
                     "x": res.x, "initial_energy": res.initial_energy,
                     "n_iter": res.n_iter, "frozen": frozen}
    cal = x["calibration"]
    inputs = dict(
        channel_stacks=(_cpu(cal["stacks"]), None, _cpu(cal["exposures"])),
        pca_arrays=cal["pca"][None], mean_icrf_arrays=cal["mean_icrf"][None],
        config=CameraConfig(num_of_chs=1, datapoints=256), mesh=mesh,
        device="cpu")
    out["calibration"] = tcal.calibration(-1.0, 1.0, **inputs, **cal["kw"])
    out["checkpoint"] = tcal.calibration(
        -1.0, 1.0, checkpoint_path=directory / "de.ckpt", checkpoint_every=5,
        **inputs, **dict(cal["kw"], refine_rounds=0, polish_steps=0))
    return out


def main() -> int:
    import torch

    from camera_linearity_tpu_torch.parallel import distributed as pdist
    from camera_linearity_tpu_torch.utils.checkpoint import save_pytree

    case, directory = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    assert pdist.initialize(device="cpu", timeout_s=INIT_TIMEOUT_S) \
        or int(os.environ["CL_NUM_PROCESSES"]) == 1
    try:
        rank, world = pdist.process_index(), pdist.process_count()
        out = globals()[f"case_{case}"](directory, rank, world)
        save_pytree(directory / f"{case}_{rank}.pt", out)
    finally:
        pdist.shutdown()
    print(f"{case} process {rank} of {world}: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
