"""Build and load the CUDA kernels of this directory.

Each ``.cu`` here has a plain C interface: ``nvcc`` compiles it for Hopper
(sm_90a) into a shared library that ``ctypes`` loads, without PyTorch's
headers (which would make the build take minutes instead of seconds).
``hdr_merge.cu`` holds K1, ``hdr_merge_lerp.cu`` K2 and K3,
``exp_ablation.cu`` the kernel experiments' E1-E5 and ``exp_lut_merge.cu``
E6 and E7.  The build runs on first use, never at import, each source in
its own ``nvcc``, all at once, into
``build/torch_kernels/<source>-<hash of source and flags>/`` beside the
package; a changed source builds anew (a source includes no header of this
directory, so its own bytes are all the hash needs).  The first use of a
merge kernel builds the two merge sources; an experiment's source is built
only when one of its experiments first runs, or by :func:`build` with no
arguments.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["build", "library", "SOURCES", "MERGE_SOURCES", "NVCC_FLAGS",
           "BUILD_SECONDS"]

_HERE = Path(__file__).resolve().parent
SOURCES = ("hdr_merge", "hdr_merge_lerp", "exp_ablation", "exp_lut_merge")
MERGE_SOURCES = SOURCES[:2]  # built together on a merge kernel's first use
_BUILD_ROOT = _HERE.parent.parent / "build" / "torch_kernels"

# no -use_fast_math: the kernels round with rintf and weight with expf, and
# are held to the plain PyTorch versions at f32 tolerance; -ldl for the
# tensor-map encoder that hdr_merge_lerp.cu looks up in libcuda
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-ldl")

_libs: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}  # wall of each nvcc run, by source


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA merge "
                           "kernels are built from source on first use")
    return found


def _lib_path(name: str) -> Path:
    source = (_HERE / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return _BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def _compile(name: str, lib: Path) -> float:
    """``nvcc`` of ``<name>.cu`` into ``lib``; its wall seconds."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_HERE / f"{name}.cu")],
        capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{name}.cu: nvcc failed with code "
                           f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    (lib.parent / "ptxas.log").write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    return seconds


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile each of ``names`` not built already, all at once; return
    each library's path by source name and record each compile's wall in
    :data:`BUILD_SECONDS`.  ``ptxas.log`` beside a library holds its
    kernels' registers, shared memory and spills."""
    paths = {name: _lib_path(name) for name in names}
    todo = {name: lib for name, lib in paths.items() if not lib.exists()}
    if not todo:
        return paths
    with ThreadPoolExecutor(len(todo)) as pool:
        running = {name: pool.submit(_compile, name, lib)
                   for name, lib in todo.items()}
    failed = []
    for name, future in running.items():
        try:
            BUILD_SECONDS[name] = future.result()
        except RuntimeError as e:
            failed.append(str(e))
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cu``, built on the first call (with
    the other merge source, for a merge kernel)."""
    if name not in _libs:
        group = MERGE_SOURCES if name in MERGE_SOURCES else (name,)
        _libs[name] = _declare(ctypes.CDLL(str(build(group)[name])))
    return _libs[name]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    signatures = {
        "cl_merge_fused": [p, i, p, p, p, i, p, ll, i, i, i, i, i, f, p, p,
                           p, p],
        "cl_merge_lerp": [p, i, p, p, p, i, p, ll, i, i, i, i, i, f, f, p, p,
                          p, p],
        "cl_merge_lerp_bp": [p, p, p, i, f, p, p, i, p, i, i, i, i, i, f, p,
                             p, p, p],
        "cl_exposure_sum": [p, p, p, p, ll, i, ll, i, i, i, p],
        "cl_merge_nolut": [p, p, ctypes.POINTER(f), p, p, ll, i, ll, i, p],
        "cl_merge_pipelined": [p, p, p, p, ctypes.POINTER(f), p, p, i, i, ll,
                               i, p, p],
        "cl_merge_table_form": [p, p, p, p, ctypes.POINTER(f), p, p, i, i,
                                ll, i, i, p],
    }
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
