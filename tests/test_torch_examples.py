"""The port's examples (``examples/torch_*.py``), each run as a user runs
it, in a subprocess with ``--device cpu`` at its smallest size and a
timeout of its own; the distributed one as a gloo world of one.  None of
them imports JAX, cv2 or matplotlib, and without ``--device cpu`` each
asks for the card and raises where there is none."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"

# example -> (smallest-size arguments, a line its output must hold, timeout)
CASES = {
    "torch_end_to_end": (["--size", "16", "--maxiter", "30"],
                         "pairwise relative-difference means", 240),
    "torch_video_pipeline": (["--frames", "6", "--size", "16", "24"],
                             "HDR from video on cpu", 120),
    "torch_distributed_batch": (["--scenes", "2", "--frames", "3"],
                                "[0] scene1: HDR (24, 32, 3)", 120),
}


def _run(args, timeout):
    # one intra-op thread: the suite's workers share the host's cores, and
    # an example's thread pool among them slows it tenfold
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for key in ("CL_COORDINATOR_ADDRESS", "CL_NUM_PROCESSES",
                "CL_PROCESS_ID"):
        env.pop(key, None)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("name", list(CASES))
def test_example_runs_on_the_cpu(name, tmp_path):
    extra, expect, timeout = CASES[name]
    out = _run([str(EXAMPLES / f"{name}.py"), str(tmp_path / "out"),
                "--device", "cpu", *extra], timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    assert expect in out.stdout, out.stdout
    assert "done" in out.stdout or "scene" in out.stdout


@pytest.mark.parametrize("name", list(CASES))
def test_example_without_a_card_raises(name, tmp_path):
    """The default device is the card: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run([str(EXAMPLES / f"{name}.py"), str(tmp_path / "out")], 120)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr


def test_examples_import_no_jax_cv2_or_matplotlib():
    code = (
        "import importlib.util, sys\n"
        f"sys.path.insert(0, {str(EXAMPLES)!r})\n"
        f"for name in {sorted(CASES)!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(\n"
        f"        name, {str(EXAMPLES)!r} + '/' + name + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'cv2', 'PIL',\n"
        "                                    'camera_linearity_tpu',\n"
        "                                    'matplotlib')))\n")
    out = _run(["-c", code], 120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
