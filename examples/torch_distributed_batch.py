"""Multi-process batch video -> HDR walkthrough through the PyTorch port
(BASELINE config 5 at scale).

The port's counterpart of ``examples/distributed_batch.py``: every process
runs THIS SAME script in one ``torch.distributed`` world (NCCL on
``--device cuda``, the default, one card a process; gloo with ``--device
cpu``).  The scene batch shards as contiguous blocks over the processes,
each process decodes only its own block, merges it on its own device (on
CUDA, one launch of the fused merge kernel) and gets its own scenes' HDR
results back; no scene's pixels cross processes.  The scenes are raw
``RGBA`` AVIs written by a small writer of the script's own (no cv2).

Run it three ways:

1. One process, a world of one (the default; a ``file://`` rendezvous in
   the output directory)::

       python examples/torch_distributed_batch.py /tmp/dist_demo

2. Several processes, one a card: the same command in each, with its
   rank (or ``CL_COORDINATOR_ADDRESS`` / ``CL_NUM_PROCESSES`` /
   ``CL_PROCESS_ID``)::

       python examples/torch_distributed_batch.py /tmp/dist_demo \\
           --coordinator localhost:29511 --num-processes 2 --process-id 0 &
       python examples/torch_distributed_batch.py /tmp/dist_demo \\
           --coordinator localhost:29511 --num-processes 2 --process-id 1 \\
           --local-device 1

3. On the CPU, two gloo processes on one machine: add ``--device cpu``.

The CLI equivalent is ``python -m camera_linearity_tpu_torch ...
--coordinator HOST:PORT --num-processes N --process-id I``.
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402

from camera_linearity_tpu_torch import CameraConfig  # noqa: E402
from camera_linearity_tpu_torch.models import pipeline  # noqa: E402
from camera_linearity_tpu_torch.parallel import distributed as dist  # noqa
from camera_linearity_tpu_torch.utils.device import resolve_device  # noqa

sys.path.insert(0, str(Path(__file__).parent))
from torch_video_pipeline import write_rgba_avi  # noqa: E402


def make_scene_videos(root: Path, n_scenes: int = 4, frames: int = 6,
                      size=(24, 32), seed: int = 7) -> None:
    rng = np.random.default_rng(seed)
    h, w = size
    for k in range(n_scenes):
        sdir = root / f"scene{k}"
        sdir.mkdir(parents=True, exist_ok=True)
        base = rng.uniform(0.1, 0.8, (h, w, 3))
        for ms in (2, 4, 8):
            u8 = np.clip(base * (ms / 8) * 255
                         + rng.normal(0, 4, (frames, h, w, 3)),
                         0, 255).astype(np.uint8)
            write_rgba_avi(sdir / f"scene {ms}ms.avi", u8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", type=Path)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: NCCL; cpu: gloo)")
    ap.add_argument("--coordinator", default=os.environ.get(
        "CL_COORDINATOR_ADDRESS"), help="HOST:PORT of rank 0")
    ap.add_argument("--num-processes", type=int, default=int(os.environ.get(
        "CL_NUM_PROCESSES", "1")))
    ap.add_argument("--process-id", type=int, default=int(os.environ.get(
        "CL_PROCESS_ID", "0")))
    ap.add_argument("--local-device", type=int, default=0,
                    help="this process's card")
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--frames", type=int, default=6)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    root = args.outdir or Path(tempfile.mkdtemp(prefix="clt_dist_demo_"))
    root.mkdir(parents=True, exist_ok=True)
    if args.coordinator is None and args.num_processes > 1:
        raise SystemExit("--coordinator is needed for more than one process")

    # 1. Join the world: a world of one rendezvouses through a file
    coordinator = args.coordinator or \
        f"file://{(root / 'rendezvous').resolve()}"
    if args.coordinator is None:
        (root / "rendezvous").unlink(missing_ok=True)
    dist.initialize(coordinator, args.num_processes, args.process_id,
                    local_device_ids=[args.local_device]
                    if dev.type == "cuda" else None, device=dev)
    rank, world = dist.process_index(), dist.process_count()
    backend = tdist.get_backend()
    print(f"[{rank}] joined: {world} process(es) over {backend} on {dev}")
    try:
        # 2. Every process must see the same scenes in the same order; rank
        #    0 writes the demo data and the rest wait for it
        scenes_dir = root / "scenes"
        if rank == 0:
            make_scene_videos(scenes_dir, args.scenes, args.frames)
        tdist.barrier()
        names = sorted(p.name for p in scenes_dir.iterdir() if p.is_dir())
        scenes = {name: sorted((scenes_dir / name).glob("*.avi"))
                  for name in names}

        # 3. One call: decode the local block, merge it, local results.  (A
        #    solved ICRF would come from `calibrate`; the demo uses a
        #    gamma curve.)
        x = np.linspace(0, 1, 256)[:, None].repeat(3, 1)
        results = pipeline.batch_video_to_hdr_distributed(
            scenes, torch.as_tensor(x ** 2.2), config=CameraConfig(),
            device=dev)
        for name, hdr in results.items():
            v = hdr.measurand.val
            print(f"[{rank}] {name}: HDR {tuple(v.shape)}, radiance mean "
                  f"{float(v.mean()):.4g}, std mean "
                  f"{float(hdr.measurand.std.mean()):.4g}")
        if not results:
            raise SystemExit(f"[{rank}] no scenes came back")
    finally:
        dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
