"""ctypes bindings for the native host-staging library, the MJPEG decoder,
the TIFF codec and the PNG, HuffYUV, FFV1, UtVideo, Lagarith, MPEG-4
Part 2 and H.264 frame decoders.

Port of ``camera_linearity_tpu/native``, copied: importing the JAX package
would import JAX.  ``stager.cpp`` (exact integer moments of uint8 frames
and their fused finalize, u8 -> f32 normalization, a running Welford
update from uint8 frames),
``jpeg.cpp`` (JPEG into BGR, the port's own, giving libjpeg-turbo's or
cv2's bytes; the JPEG chunks of a TIFF as libtiff has libjpeg decode
them; and the frames of uncompressed AVIs as cv2 gives them) and
``tiff.cpp`` (TIFF LZW, PackBits, predictors and CCITT fax decoding, the
port's own), ``png.cpp`` (PNG frames of an AVI: unfiltering, Adam7 and
the conversion to BGR; Python's ``zlib`` inflates), ``huffyuv.cpp``
(HuffYUV frames of an AVI), ``ffv1.cpp`` (FFV1 frames of an AVI, a
slice a thread, the context states kept in a decoder object),
``utvideo.cpp`` (Ut Video frames of an AVI, a frame a thread),
``lagarith.cpp`` (Lagarith frames of an AVI, a plane a thread) and
``mpeg4.cpp`` (MPEG-4 Part 2 frames of an AVI: a frame parsed while the
one before it is rebuilt a macroblock row a thread, the prediction state
and the reference picture kept in a decoder object) and ``h264.cpp``
(H.264 slice data: a slice a thread, GOPs side by side, the frame slots
kept in a decoder object; ``h264_plain.Stream`` reads the headers) build
with ``g++`` on first use, never at import, into
``build/native/<stem>-<hash>.so`` beside the package (the hash covers the
source and the host's CPU features, so a changed source or another CPU
builds anew).  Every stager entry point has a pure-NumPy fallback for hosts
without a compiler; ``available()`` reports which path is active and
:func:`build_error` why a build failed.  The decoders and the TIFF codec
have no fallback: their entry points raise without the library
(``native/jpeg_plain.py``, ``tiff_plain.py``, ``png_plain.py``,
``huffyuv_plain.py``, ``ffv1_plain.py``, ``utvideo_plain.py``,
``lagarith_plain.py``, ``mpeg4_plain.py`` and ``h264_plain.py`` are the
plain versions the tests hold them to).
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

# the MJPEG decoder's modes, by their number in jpeg.cpp, and the code of
# a frame that ends before its first scan ("ffmpeg" mode: cv2 gives none)
from .jpeg_plain import MODES as JPEG_MODES, NO_FRAME as JPEG_NO_FRAME
# the output forms of a TIFF's JPEG chunks, by their number in jpeg.cpp
from .jpeg_plain import TIFF_FORMS as TIFF_JPEG_FORMS
# the uncompressed video layouts, by their number in jpeg.cpp
from .rawvideo_plain import LAYOUTS as RAW_LAYOUTS, frame_bytes
from .rawvideo_plain import MATRICES as RAW_MATRICES
from . import (ffv1_plain, h264_plain, huffyuv_plain, lagarith_plain,
               mpeg4_plain, png_plain, utvideo_plain)

__all__ = ["available", "u8_to_f32", "u8_hwc_to_cfirst_f32",
           "welford_update_batch_u8", "accum_moments_u8", "HostMoments",
           "HostWelford",
           "mmap_buffer", "WIRE_U16F16",
           "wire_quantize_u16f16", "narrow_f16", "mjpeg_available",
           "jpeg_decode_bgr", "jpeg_decode_bgr_batch", "JPEG_MODES",
           "raw_decode_bgr_batch", "RAW_LAYOUTS",
           "jpeg_decode_tiff_chunks", "TIFF_JPEG_FORMS", "tiff_available",
           "lzw_decode_chunks", "packbits_decode_chunks",
           "ccitt_decode_chunks",
           "lzw_encode_chunks", "predictor_undo",
           "predictor_apply", "build_error", "png_available",
           "png_decode_bgr_batch", "huffyuv_available",
           "huffyuv_decode_bgr_batch", "ffv1_available", "Ffv1Decoder",
           "ffv1_decode_bgr_batch", "utvideo_available",
           "utvideo_decode_bgr_batch", "lagarith_available",
           "lagarith_decode_bgr_batch", "mpeg4_available", "Mpeg4Decoder",
           "mpeg4_decode_bgr_batch", "mpeg4_flush", "h264_available",
           "H264Decoder", "h264_decode_bgr_batch"]

# The host->device wire encoding for (mean, std_of_mean) frame pairs: u16
# fixed-point mean (grid 1/65535 on the [0,1] DN scale, absolute error
# <= 2^-17) + IEEE f16 std (relative error <= 2^-11).
WIRE_U16F16 = (np.dtype(np.uint16), np.dtype(np.float16))


def wire_quantize_u16f16(mean: np.ndarray, std: Optional[np.ndarray],
                         out=None):
    """Quantize f32/f64 (mean, std) frames to the u16+f16 wire encoding.

    Bit-identical to the fused native finalize's stores
    (``clt_finalize_moments_u64_wire``): mean maps through
    ``min(max(mean*65535 + 0.5, 0), 65535)`` truncated to uint16, std
    narrows f64->f16 round-to-nearest-even.  This is the shared NumPy
    reference used by the fallback path and by device-backend callers
    that only hold float statistics.
    """
    m = np.asarray(mean, np.float64) * 65535.0 + 0.5
    np.minimum(np.maximum(m, 0.0, out=m), 65535.0, out=m)
    if out is not None:
        out[0][...] = m.astype(np.uint16)
        mq = out[0]
        if std is not None:
            out[1][...] = np.asarray(std, np.float64)
            sq = out[1]
        else:
            sq = None
    else:
        mq = m.astype(np.uint16)
        sq = None if std is None else \
            np.asarray(std, np.float64).astype(np.float16)
    return mq, sq


def mmap_buffer(shape, dtype, prefault: bool = True) -> np.ndarray:
    """NumPy array backed by a dedicated anonymous mmap (THP-advised),
    zero-filled page by page up front with ``prefault``.

    For multi-hundred-MB buffers that live for the whole process (decode
    pools, moment accumulators): backing them with their own mapping avoids
    the brk heap's first-touch fault rate, requests transparent hugepages
    (MADV_HUGEPAGE) where the kernel honors madvise, and (with
    ``prefault``) pays the page-fault cost once, up front, at
    sequential-fill speed rather than scattered through a decode loop.
    glibc's allocator keeps its defaults (large NumPy temporaries become
    plain mmaps).
    """
    import mmap as _mmap
    dt = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dt.itemsize
    buf = _mmap.mmap(-1, max(nbytes, 1))
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        libc.madvise(ctypes.c_void_p(addr), ctypes.c_size_t(nbytes),
                     14)  # MADV_HUGEPAGE
    except (OSError, ValueError):
        pass
    arr = np.frombuffer(buf, dtype=dt, count=int(np.prod(shape))
                        ).reshape(shape)
    if prefault:
        arr.view(np.uint8).reshape(-1)[:] = 0
    return arr


_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "stager.cpp"
_MJPEG_SRC = _DIR / "jpeg.cpp"
_TIFF_SRC = _DIR / "tiff.cpp"
_PNG_SRC = _DIR / "png.cpp"
_HUFFYUV_SRC = _DIR / "huffyuv.cpp"
_FFV1_SRC = _DIR / "ffv1.cpp"
_UTVIDEO_SRC = _DIR / "utvideo.cpp"
_LAGARITH_SRC = _DIR / "lagarith.cpp"
_MPEG4_SRC = _DIR / "mpeg4.cpp"
_H264_SRC = _DIR / "h264.cpp"
_BUILD_ROOT = _DIR.parent.parent / "build" / "native"


def _host_tag(src: Path = _SRC) -> str:
    """Identify the CPU + source the library was compiled for.

    ``-march=native`` output is only valid on hosts with the same feature
    set: a library built on an AVX-512 host would SIGILL at first call on
    an older one (the load succeeds; the failure is at execution, past the
    fallback gate).  The tag hashes the machine + cpuinfo feature flags AND
    the source contents, so any mismatch rebuilds.
    """
    import hashlib
    import platform
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = line
                    break
    except OSError:
        pass
    h = hashlib.md5(usedforsecurity=False)  # cache key, not security
    h.update(platform.machine().encode())
    h.update(feats.encode())
    text = src.read_bytes()
    h.update(text)
    for header in re.findall(rb'#include "([^"]+)"', text):  # parallel.h
        h.update((src.parent / header.decode()).read_bytes())
    return h.hexdigest()[:10]


def _lib_path(stem: str = "_stager", src: Path = _SRC) -> Path:
    """``build/native/<stem>-<host and source hash>.so``."""
    return _BUILD_ROOT / f"{stem}-{_host_tag(src)}.so"


_lib: Optional[ctypes.CDLL] = None
_tried = False
_build_errors: Dict[str, str] = {}

_NTHREADS = min(16, os.cpu_count() or 1)


def build_error(stem: str = "_stager") -> Optional[str]:
    """Why the last build of ``stem`` (``"_stager"``, ``"_mjpeg"``,
    ``"_tiff"``, ``"_png"``, ``"_huffyuv"``, ``"_ffv1"``, ``"_utvideo"``,
    ``"_lagarith"`` or ``"_mpeg4"``)
    failed, or None when it did not fail."""
    return _build_errors.get(stem)


def _build(lib_path: Path, src: Path = _SRC, extra_flags=()) -> bool:
    # Compile to a process-private temp name and os.replace() into place:
    # rename is atomic on POSIX, so a concurrent first use in another
    # process sees either no file or a COMPLETE library, never a
    # half-written one.
    stem = lib_path.name.split("-")[0]
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.stem}.tmp{os.getpid()}.so")
    base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
            str(src), "-o", str(tmp)] + list(extra_flags)
    # -march=native vectorizes the u8 moment accumulation wider (AVX2 vs
    # baseline SSE2); fall back to the portable build where the compiler
    # rejects it
    errors = []
    for cmd in ([base[0], "-march=native"] + base[1:], base):
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True,
                           timeout=120)
            os.replace(tmp, lib_path)
            _prune_stale_libs(lib_path)
            _build_errors.pop(stem, None)
            return True
        except subprocess.CalledProcessError as exc:
            errors.append(f"{' '.join(cmd)}: {exc.stderr.strip()}")
        except (subprocess.SubprocessError, OSError) as exc:
            errors.append(f"{' '.join(cmd)}: {exc}")
    tmp.unlink(missing_ok=True)
    _build_errors[stem] = "\n".join(errors)
    return False


def _prune_stale_libs(keep: Path, min_age_s: float = 600.0) -> None:
    """Drop libraries built for other source/host hashes (they accumulate
    one per code change otherwise); best-effort — a library mapped by a
    running process keeps working after unlink on POSIX.  Only libraries
    older than ``min_age_s`` are touched, so a concurrent process of
    another source version keeps the one it just built."""
    import time
    now = time.time()
    stem = keep.name.split("-")[0]  # _stager / _mjpeg / _png ...: own kind
    for p in keep.parent.glob(f"{stem}-*.so"):
        if p == keep or ".tmp" in p.name:
            continue
        try:
            if now - p.stat().st_mtime >= min_age_s:
                p.unlink()
        except OSError:
            pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # the filename embeds host + source-content hashes, so existence IS
    # freshness
    try:
        lib_path = _lib_path()
        if not lib_path.exists() and not _build(lib_path):
            return None
        lib = ctypes.CDLL(str(lib_path))
    except OSError as exc:
        _build_errors["_stager"] = f"load failed: {exc}"
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    sz, dbl, i = ctypes.c_size_t, ctypes.c_double, ctypes.c_int
    i64 = ctypes.c_int64
    try:
        lib.clt_u8_to_f32.argtypes = [u8p, f32p, sz, ctypes.c_float, i]
        lib.clt_u8_hwc_to_cfirst_f32.argtypes = [u8p, f32p, sz, sz,
                                                 ctypes.c_float, i]
        lib.clt_welford_update_u8.argtypes = [u8p, f64p, f64p, sz, dbl, i64,
                                              i]
        lib.clt_welford_update_batch_u8.argtypes = [u8p, f64p, f64p, sz, sz,
                                                    dbl, i64, i]
        lib.clt_accum_moments_u8.argtypes = [u8p, sz, sz, u64p, u64p, i]
        lib.clt_finalize_moments_u64.argtypes = [
            u64p, u64p, sz, dbl, dbl, f64p, f64p, i]
        lib.clt_finalize_moments_u64_f32.argtypes = [
            u64p, u64p, sz, dbl, dbl, f32p, f32p, i]
        lib.clt_finalize_moments_u64_wire.argtypes = [
            u64p, u64p, sz, dbl, dbl, u16p, u16p, i]
        lib.clt_f64_to_f16.argtypes = [f64p, u16p, sz]
        for fn in (lib.clt_u8_to_f32, lib.clt_u8_hwc_to_cfirst_f32,
                   lib.clt_welford_update_u8,
                   lib.clt_welford_update_batch_u8,
                   lib.clt_accum_moments_u8, lib.clt_finalize_moments_u64,
                   lib.clt_finalize_moments_u64_f32,
                   lib.clt_finalize_moments_u64_wire, lib.clt_f64_to_f16):
            fn.restype = None
        lib.clt_version.restype = ctypes.c_int
    except AttributeError as exc:  # a library from another source version
        _build_errors["_stager"] = f"symbol missing: {exc}"
        return None
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native stager library built (or was built) and
    loaded; False means the NumPy fallbacks run."""
    return _load() is not None


def _declare_mjpeg(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    sz, i = ctypes.c_size_t, ctypes.c_int
    lib.clt_jpeg_decode_bgr.argtypes = [u8p, sz, u8p, i, i, i]
    lib.clt_jpeg_decode_bgr.restype = i
    lib.clt_jpeg_decode_bgr_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(sz), sz, u8p, i, i,
        i, i, ctypes.POINTER(i)]
    lib.clt_jpeg_decode_bgr_batch.restype = None
    lib.clt_raw_decode_bgr_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(sz), sz, u8p, i, i,
        i, i, u8p, i, i, ctypes.POINTER(i)]
    lib.clt_raw_decode_bgr_batch.restype = None
    lib.clt_jpeg_decode_tiff_batch.argtypes = [
        u8p, sz, u8p, sz, u64p, u64p, sz, u8p, u64p, ctypes.POINTER(i), i, i,
        i, i, i, ctypes.POINTER(i)]
    lib.clt_jpeg_decode_tiff_batch.restype = None
    lib.clt_jpeg_version.restype = i


def _declare_tiff(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    sz, i = ctypes.c_size_t, ctypes.c_int
    lib.clt_lzw_decode_chunks.argtypes = [
        u8p, sz, u64p, u64p, sz, u8p, u64p, u64p, i64p, i]
    lib.clt_packbits_decode_chunks.argtypes = [
        u8p, sz, u64p, u64p, sz, u8p, u64p, u64p, i64p, i]
    lib.clt_lzw_encode_chunks.argtypes = [
        u8p, u64p, u64p, sz, u8p, u64p, u64p, u64p, i]
    lib.clt_predictor_undo.argtypes = [u8p, sz, sz, i, i, i, i, i]
    lib.clt_predictor_apply.argtypes = [u8p, sz, sz, i, i, i]
    lib.clt_ccitt_decode_chunks.argtypes = [
        u8p, sz, u64p, u64p, sz, u8p, u64p, u64p,
        ctypes.POINTER(ctypes.c_int32), i, i, i, i64p, i]
    for fn in ("clt_ccitt_decode_chunks", "clt_lzw_decode_chunks",
               "clt_packbits_decode_chunks", "clt_lzw_encode_chunks"):
        getattr(lib, fn).restype = None
    lib.clt_predictor_undo.restype = i
    lib.clt_predictor_apply.restype = i
    lib.clt_tiff_version.restype = i


def _declare_png(lib: ctypes.CDLL) -> None:
    sz, i, vpp = ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
    lib.clt_png_decode_bgr_batch.argtypes = [
        vpp, ctypes.POINTER(sz), sz, ctypes.POINTER(ctypes.c_uint8), i, i, i,
        i, i, vpp, ctypes.POINTER(i), i, ctypes.POINTER(i)]
    lib.clt_png_decode_bgr_batch.restype = None
    lib.clt_png_version.restype = i


def _declare_huffyuv(lib: ctypes.CDLL) -> None:
    sz, i = ctypes.c_size_t, ctypes.c_int
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.clt_huffyuv_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(sz), sz, u8p, u8p, sz,
        i, i, i, i, i, i, u8p, ctypes.POINTER(ctypes.c_uint32), i,
        ctypes.POINTER(i)]
    lib.clt_huffyuv_decode_batch.restype = None
    lib.clt_huffyuv_version.restype = i


def _declare_ffv1(lib: ctypes.CDLL) -> None:
    sz, i, vp = ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p
    u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    lib.clt_ffv1_new.argtypes = [ip, ctypes.POINTER(ctypes.c_int16), ip, ip,
                                 u8p, u8p, i, i]
    lib.clt_ffv1_new.restype = vp
    lib.clt_ffv1_free.argtypes = [vp]
    lib.clt_ffv1_free.restype = None
    lib.clt_ffv1_decode_batch.argtypes = [
        vp, ctypes.POINTER(vp), ctypes.POINTER(sz), sz, u8p, u8p, sz, i, ip,
        ip]
    lib.clt_ffv1_decode_batch.restype = None
    lib.clt_ffv1_version.restype = i


def _declare_utvideo(lib: ctypes.CDLL) -> None:
    sz, i = ctypes.c_size_t, ctypes.c_int
    u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    lib.clt_utvideo_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(sz), sz, u8p, u8p, sz,
        i, i, i, i, i, i, ip, ip]
    lib.clt_utvideo_decode_batch.restype = None
    lib.clt_utvideo_version.restype = i


def _declare_lagarith(lib: ctypes.CDLL) -> None:
    sz, i = ctypes.c_size_t, ctypes.c_int
    u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    lib.clt_lagarith_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(sz), sz, u8p, u8p, sz,
        i, i, i, ip, ip]
    lib.clt_lagarith_decode_batch.restype = None
    lib.clt_lagarith_version.restype = i


def _declare_mpeg4(lib: ctypes.CDLL) -> None:
    i, sz, ip = ctypes.c_int, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int)
    szp = ctypes.POINTER(sz)
    lib.clt_mpeg4_new.argtypes = [i, i, i, i]
    lib.clt_mpeg4_new.restype = ctypes.c_void_p
    lib.clt_mpeg4_free.argtypes = [ctypes.c_void_p]
    lib.clt_mpeg4_free.restype = None
    lib.clt_mpeg4_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), szp, szp, ip, ip,
        sz, ctypes.POINTER(ctypes.c_uint8), sz, i, ip, ip]
    lib.clt_mpeg4_decode_batch.restype = None
    lib.clt_mpeg4_version.restype = i


def _declare_h264(lib: ctypes.CDLL) -> None:
    i, sz, vp = ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p
    ip, szp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_size_t)
    lib.clt_h264_new.argtypes = [i, i, i]
    lib.clt_h264_new.restype = vp
    lib.clt_h264_free.argtypes = [vp]
    lib.clt_h264_free.restype = None
    lib.clt_h264_grow.argtypes = [vp, i]
    lib.clt_h264_grow.restype = None
    lib.clt_h264_decode_batch.argtypes = [
        vp, ip, sz, ctypes.POINTER(ctypes.c_void_p), szp, szp, szp, ip, i,
        ip, ip]
    lib.clt_h264_decode_batch.restype = None
    lib.clt_h264_output.argtypes = [vp, i, i, i, i, i, ctypes.c_void_p]
    lib.clt_h264_output.restype = None
    lib.clt_h264_version.restype = i
    lib.clt_h264_params.restype = i


# stem: (source, extra g++ flags, entry-point types, what it is).  -fwrapv
# for jpeg.cpp: the IDCTs' sums of corrupt coefficients wrap, as libjpeg's
# 32-bit lanes do, instead of being undefined.
_DECODERS = {
    "_mjpeg": (_MJPEG_SRC, ("-fwrapv",), _declare_mjpeg, "MJPEG decoder"),
    "_tiff": (_TIFF_SRC, (), _declare_tiff, "TIFF codec"),
    "_png": (_PNG_SRC, (), _declare_png, "PNG decoder"),
    "_huffyuv": (_HUFFYUV_SRC, (), _declare_huffyuv, "HuffYUV decoder"),
    "_ffv1": (_FFV1_SRC, (), _declare_ffv1, "FFV1 decoder"),
    "_utvideo": (_UTVIDEO_SRC, (), _declare_utvideo, "UtVideo decoder"),
    "_lagarith": (_LAGARITH_SRC, (), _declare_lagarith, "Lagarith decoder"),
    "_mpeg4": (_MPEG4_SRC, ("-fwrapv",), _declare_mpeg4,
               "MPEG-4 Part 2 decoder"),
    "_h264": (_H264_SRC, ("-fwrapv",), _declare_h264, "H.264 decoder"),
}
_decoder_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def _load_decoder(stem: str) -> Optional[ctypes.CDLL]:
    """Load (building on first use) the library ``stem`` of
    ``_DECODERS``; one try a process."""
    if stem in _decoder_libs:
        return _decoder_libs[stem]
    _decoder_libs[stem] = None
    src, flags, declare, _ = _DECODERS[stem]
    try:
        lib_path = _lib_path(stem, src)
        if not lib_path.exists() and not _build(lib_path, src, flags):
            return None
        lib = ctypes.CDLL(str(lib_path))
        declare(lib)
    except (OSError, AttributeError) as exc:
        _build_errors[stem] = f"load failed: {exc}"
        return None
    _decoder_libs[stem] = lib
    return lib


def _require(lib: Optional[ctypes.CDLL], stem: str) -> ctypes.CDLL:
    if lib is None:
        raise RuntimeError(f"native {_DECODERS[stem][3]} unavailable (a C++ "
                           f"compiler is needed): {build_error(stem)}")
    return lib


def _load_mjpeg() -> Optional[ctypes.CDLL]:
    """Load (building on first use) the MJPEG decoder (``jpeg.cpp``)."""
    return _load_decoder("_mjpeg")


def mjpeg_available() -> bool:
    """True when the MJPEG decoder built (or was built) and loaded."""
    return _load_mjpeg() is not None


def _mjpeg() -> ctypes.CDLL:
    return _require(_load_mjpeg(), "_mjpeg")


def _check_frames(dst: np.ndarray, ndim: int, what: str) -> None:
    if dst.dtype != np.uint8 or dst.ndim != ndim or dst.shape[-1] != 3 or \
            not dst.flags.c_contiguous or not dst.flags.writeable:
        raise ValueError(f"dst must be a writable C-contiguous {what} "
                         "uint8 array")


def _jpeg_mode(mode: Optional[str], fast: bool) -> int:
    """A mode's number in jpeg.cpp; ``mode=None`` takes the old ``fast``
    flag (False: ``"turbo"``, True: ``"turbo_fast"``)."""
    if mode is None:
        return 1 if fast else 0
    if mode not in JPEG_MODES:
        raise ValueError(f"unknown JPEG decoder mode {mode!r}; expected one "
                         f"of {JPEG_MODES}")
    return JPEG_MODES.index(mode)


def _jpeg_error(rc: int, payload, shape, mode: int = 0,
                frame: Optional[int] = None) -> ValueError:
    """The ValueError for a decoder return code; an unsupported frame's
    (and a frame of other than three components) names the feature its
    headers show, and ``frame`` (an index) names the frame."""
    at = "" if frame is None else f"frame {frame}: "
    if rc in (-3, -4):
        from ..utils.avi import jpeg_unsupported
        why = jpeg_unsupported(bytes(payload), mode=JPEG_MODES[mode]) or \
            "a mode it does not read"
        what = "unsupported JPEG" if rc == -4 else \
            "not a 1- or 3-component image" if JPEG_MODES[mode] == "ffmpeg" \
            else "not a 3-component image"
        return ValueError(f"jpeg_decode_bgr: {at}{what}: {why}")
    reasons = {-1: "corrupt JPEG data",
               -2: f"frame geometry != {tuple(shape)}",
               -5: "data FFmpeg decodes with an error it conceals (cv2 "
                   "returns a frame the 'ffmpeg' mode cannot match)",
               -6: "the data ends before the first scan (cv2 returns no "
                   "frame)"}
    return ValueError(f"jpeg_decode_bgr: {at}{reasons.get(rc, rc)}")


def jpeg_decode_bgr(src, dst: np.ndarray, fast: bool = False,
                    mode: Optional[str] = None) -> None:
    """Decode one JPEG byte string/buffer into ``dst`` (H, W, 3) BGR uint8.

    ``mode`` (one of ``JPEG_MODES``; None takes ``fast``): ``"turbo"``
    gives libjpeg-turbo's bytes with its JDCT_ISLOW IDCT and fancy chroma
    upsampling, ``"turbo_fast"`` (``fast=True``) JDCT_IFAST and replicated
    (merged) chroma, ``"ffmpeg"`` what ``cv2.VideoCapture`` gives for an
    MJPG frame (FFmpeg's decoder and swscale), three channels whatever the
    frame's component count.  Raises ValueError on
    malformed data, a geometry mismatch, a mode the decoder does not read
    (naming it) or, in ``"ffmpeg"`` mode, data FFmpeg conceals errors in or
    gives no frame for.
    """
    lib = _mjpeg()
    m = _jpeg_mode(mode, fast)
    _check_frames(dst, 3, "(H, W, 3)")
    # zero-copy pointer to the source payload (np.frombuffer accepts both
    # read-only bytes and writable buffers without copying)
    flat = np.frombuffer(src, np.uint8)
    rc = lib.clt_jpeg_decode_bgr(
        _as_u8_ptr(flat), flat.size, _as_u8_ptr(dst), dst.shape[0],
        dst.shape[1], m)
    if rc != 0:
        raise _jpeg_error(rc, flat, dst.shape[:2], m)


def jpeg_decode_bgr_batch(payloads, dst: np.ndarray, fast: bool = False,
                          threads: Optional[int] = None,
                          mode: Optional[str] = None,
                          first_frame: int = 0) -> int:
    """Decode JPEG payload i into ``dst[i]`` ((k, H, W, 3) BGR uint8, k =
    ``len(payloads)``) on up to ``threads`` threads (default: every CPU),
    as :func:`jpeg_decode_bgr` decodes each.  Returns the number of frames
    before the first that gives no frame (``"ffmpeg"`` mode, where cv2's
    stream ends: k when every frame decoded), and raises the first failing
    frame's ValueError before it, after every frame was tried; errors name
    frames from ``first_frame``."""
    lib = _mjpeg()
    m = _jpeg_mode(mode, fast)
    _check_frames(dst, 4, "(k, H, W, 3)")
    k = len(payloads)
    if dst.shape[0] != k:
        raise ValueError(f"dst holds {dst.shape[0]} frames, "
                         f"payloads {k}")
    # the arrays keep every payload alive across the call
    flats = [np.frombuffer(p, np.uint8) for p in payloads]
    ptrs = (ctypes.c_void_p * k)(*[f.ctypes.data for f in flats])
    sizes = (ctypes.c_size_t * k)(*[f.size for f in flats])
    rcs = (ctypes.c_int * k)()
    lib.clt_jpeg_decode_bgr_batch(
        ptrs, sizes, k, _as_u8_ptr(dst), dst.shape[1], dst.shape[2],
        m, threads or os.cpu_count() or 1, rcs)
    for i, rc in enumerate(rcs):
        if rc == JPEG_NO_FRAME:
            return i
        if rc != 0:
            raise _jpeg_error(rc, flats[i], dst.shape[1:3], m,
                              first_frame + i)
    return k


def jpeg_decode_tiff_chunks(tables, src: np.ndarray, offsets, counts,
                            dst: np.ndarray, dst_offsets, heights,
                            width: int, form: str,
                            sampling=(1, 1)) -> np.ndarray:
    """Decode the JPEG chunks (TIFF compression 7) of the file image
    ``src`` (chunk i: bytes ``offsets[i]`` to ``offsets[i] + counts[i]``)
    with one JPEGTables stream ``tables`` (bytes; empty for none) into
    ``dst``, chunk i at ``dst_offsets[i]``, ``heights[i]`` x ``width``
    pixels of 3 bytes (``form`` "ycc": YCbCr converted to RGB; "stored":
    three components as stored) or 1 ("gray"), as libtiff has libjpeg
    decode them for TIFFReadRGBA* and ``jpeg_plain.decode_tiff`` decodes
    each; ``sampling``: the YCbCrSubSampling "ycc" holds the first
    component to.  On all threads.  Returns each chunk's return code
    (int32): 0, or ``jpeg_plain``'s codes (SAMPLING -8, and -9 for a
    chunk outside the file)."""
    lib = _mjpeg()
    if form not in TIFF_JPEG_FORMS:
        raise ValueError(f"unknown TIFF JPEG form {form!r}; expected one of "
                         f"{TIFF_JPEG_FORMS}")
    tab = np.frombuffer(bytes(tables), np.uint8)
    src_p = _u8_buffer(src, "src")
    offsets, counts = _u64(offsets, "offsets"), _u64(counts, "counts")
    dst_offsets = _u64(dst_offsets, "dst_offsets")
    heights = np.ascontiguousarray(heights, np.int32)
    if not offsets.shape == counts.shape == dst_offsets.shape == \
            heights.shape:
        raise ValueError("offsets, counts, dst_offsets and heights differ "
                         "in length")
    channels = 1 if form == "gray" else 3
    _check_ranges(dst_offsets, heights.astype(np.uint64) * width * channels,
                  dst.size, "dst")
    dst_p = _u8_buffer(dst, "dst", writable=True)
    rcs = np.empty(offsets.size, np.int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.clt_jpeg_decode_tiff_batch(
        _as_u8_ptr(tab), tab.size, src_p, src.size,
        offsets.ctypes.data_as(u64p), counts.ctypes.data_as(u64p),
        offsets.size, dst_p, dst_offsets.ctypes.data_as(u64p),
        heights.ctypes.data_as(ip), width, TIFF_JPEG_FORMS.index(form),
        int(sampling[0]), int(sampling[1]), _NTHREADS, rcs.ctypes.data_as(ip))
    return rcs


def raw_decode_bgr_batch(payloads, dst: np.ndarray, layout: str,
                         bottom_up: bool = False,
                         palette: Optional[np.ndarray] = None,
                         threads: Optional[int] = None,
                         first_frame: int = 0, matrix: str = "bt601") -> int:
    """Decode uncompressed frame chunk i of ``layout`` (one of
    ``RAW_LAYOUTS``) into ``dst[i]`` ((k, H, W, 3) BGR uint8, k =
    ``len(payloads)``) on up to ``threads`` threads (default: every CPU),
    giving the frame ``cv2.VideoCapture`` gives for it
    (``native/rawvideo_plain.py`` has each layout's rule).  ``bottom_up``:
    the rows of a single-plane layout are stored last first (BI_RGB of
    positive height); ``palette``: pal8's (256, 4) B, G, R, X entries;
    ``matrix``: the YUV layouts' (``"bt601"``, or ``"bt709"`` for the
    planes of a stream tagged so).  Returns k; a chunk shorter than its
    frame raises ValueError naming it (from ``first_frame``), after every
    frame was tried.  Built with the MJPEG decoder, in ``jpeg.cpp``;
    raises RuntimeError where it did not build."""
    lib = _mjpeg()
    if layout not in RAW_LAYOUTS:
        raise ValueError(f"unknown raw video layout {layout!r}; expected one "
                         f"of {RAW_LAYOUTS}")
    if matrix not in RAW_MATRICES:
        raise ValueError(f"unknown matrix {matrix!r}; expected one of "
                         f"{RAW_MATRICES}")
    _check_frames(dst, 4, "(k, H, W, 3)")
    k = len(payloads)
    if dst.shape[0] != k:
        raise ValueError(f"dst holds {dst.shape[0]} frames, payloads {k}")
    if layout == "pal8":
        if palette is None or palette.shape != (256, 4):
            raise ValueError("a pal8 frame needs a (256, 4) palette")
        palette = np.ascontiguousarray(palette, np.uint8)
    flats = [np.frombuffer(p, np.uint8) for p in payloads]
    ptrs = (ctypes.c_void_p * k)(*[f.ctypes.data for f in flats])
    sizes = (ctypes.c_size_t * k)(*[f.size for f in flats])
    rcs = (ctypes.c_int * k)()
    lib.clt_raw_decode_bgr_batch(
        ptrs, sizes, k, _as_u8_ptr(dst), dst.shape[1], dst.shape[2],
        RAW_LAYOUTS.index(layout), int(bottom_up),
        None if palette is None else _as_u8_ptr(palette),
        RAW_MATRICES.index(matrix), threads or os.cpu_count() or 1, rcs)
    for i, rc in enumerate(rcs):
        if rc != 0:
            need = frame_bytes(layout, *dst.shape[1:3])
            raise ValueError(
                f"raw_decode_bgr_batch: frame {first_frame + i}: "
                + (f"{layout} chunk of {flats[i].size} bytes, shorter than "
                   f"the {dst.shape[1]} x {dst.shape[2]} frame's {need}"
                   if rc == -7 else f"return code {rc}"))
    return k


def png_available() -> bool:
    """True when the PNG frame decoder built (or was built) and loaded."""
    return _load_decoder("_png") is not None


def huffyuv_available() -> bool:
    """True when the HuffYUV decoder built (or was built) and loaded."""
    return _load_decoder("_huffyuv") is not None


def ffv1_available() -> bool:
    """True when the FFV1 decoder built (or was built) and loaded."""
    return _load_decoder("_ffv1") is not None


def lagarith_available() -> bool:
    """True when the native Lagarith decoder built (or was built) and
    loaded."""
    return _load_decoder("_lagarith") is not None


def mpeg4_available() -> bool:
    """True when the native MPEG-4 Part 2 decoder built (or was built) and
    loaded."""
    return _load_decoder("_mpeg4") is not None


def h264_available() -> bool:
    """True when the H.264 decoder (``h264.cpp``) built (or was
    built)."""
    return _load_decoder("_h264") is not None


def utvideo_available() -> bool:
    """True when the UtVideo decoder built (or was built) and loaded."""
    return _load_decoder("_utvideo") is not None


# ffv1.cpp's return codes: what went wrong, and whether it names a slice
_FFV1_REASONS = {
    -1: "its CRC fails", -2: "its size runs past the chunk",
    -3: "the first frame is no keyframe",
    -4: "its data end before its samples",
    -5: "a slice header out of range",
    -6: "a symbol of more than 32 bits, or a header out of range",
    -7: "a keyframe header that changes the stream's layout",
    -8: "another slice count than its keyframe's", -9: "an empty chunk",
    -10: "an earlier frame failed to decode (the stream's states are lost)",
    -11: "it leaves the last chroma row or column undecoded"}


class Ffv1Decoder:
    """The native decoder of one FFV1 stream of ``params``
    (``ffv1_plain.Ffv1Params``) at ``height`` x ``width``: it keeps each
    slice's context states from one :func:`ffv1_decode_bgr_batch` call to
    the next, as FFV1 resets them only on a keyframe, so it takes the
    stream's frames in order, from its first.  ``frames`` counts the frames
    it decoded.  Raises ValueError for a layout ``ffv1.cpp`` does not read
    (``ffv1_plain.unsupported``), RuntimeError where it did not build."""

    def __init__(self, params: "ffv1_plain.Ffv1Params", height: int,
                 width: int):
        self._lib = _require(_load_decoder("_ffv1"), "_ffv1")
        self._handle = None
        why = ffv1_plain.unsupported(params, height, width)
        if why:
            raise ValueError(f"an FFV1 layout the decoder does not read: "
                             f"{why} ({ffv1_plain.layout_name(params)})")
        p = params
        self.params, self.height, self.width = p, height, width
        self.layout = ffv1_plain.yuv_layout(p)
        # the YUV layouts' matrix: FFV1 names none, the container may
        self.matrix = "bt601"
        self.frames = 0
        ints = np.array([p.version, p.micro_version, p.coder, p.colorspace,
                         p.bits, int(p.chroma_planes), p.h_shift, p.v_shift,
                         int(p.transparency), p.num_h_slices, p.num_v_slices,
                         p.ec, p.plane_count, len(p.quant_tables)], np.int32)
        quant = np.ascontiguousarray(np.stack(p.quant_tables), np.int16)
        contexts = np.array(p.context_counts, np.int32)
        has = np.array([s is not None for s in p.initial_states], np.int32)
        initial = np.concatenate(
            [np.ascontiguousarray(s, np.uint8).reshape(-1)
             for s in p.initial_states if s is not None] or
            [np.zeros(1, np.uint8)])
        transition = None if p.transition is None else \
            np.ascontiguousarray(p.transition, np.uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        self._handle = self._lib.clt_ffv1_new(
            ints.ctypes.data_as(ip),
            quant.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            contexts.ctypes.data_as(ip), has.ctypes.data_as(ip),
            _as_u8_ptr(initial),
            None if transition is None else _as_u8_ptr(transition),
            height, width)
        if not self._handle:
            raise ValueError(f"FFV1 parameters out of range for a {height} x "
                             f"{width} stream")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.clt_ffv1_free(self._handle)
            self._handle = None


def ffv1_decode_bgr_batch(payloads, dst: np.ndarray, decoder: Ffv1Decoder,
                          threads: Optional[int] = None,
                          planes: Optional[np.ndarray] = None) -> int:
    """Decode the next FFV1 frame chunks of ``decoder``'s stream into
    ``dst`` ((k, H, W, 3) BGR uint8, k = ``len(payloads)``), giving the
    frames ``cv2.VideoCapture`` gives for them: ``ffv1.cpp`` a slice a
    thread on up to ``threads`` threads (default: every CPU), each thread
    decoding its slice of every frame in turn; RGB and gray straight into
    ``dst``, yuv420p, yuv422p and yuv444p into planes (``planes``: a
    reusable uint8 buffer of at least k frames' planes) that the rawvideo
    converter (``jpeg.cpp``) turns into BGR.  Returns k; raises ValueError
    naming the first frame (counted from the stream's first) and slice
    that does not decode (a CRC that fails, a slice size past the chunk, a
    first frame that is no keyframe, data that end before the samples),
    after which the decoder refuses every call; a RuntimeError where a
    library did not build."""
    lib = decoder._lib
    _check_frames(dst, 4, "(k, H, W, 3)")
    k, (h, w) = len(payloads), dst.shape[1:3]
    if dst.shape[0] != k:
        raise ValueError(f"dst holds {dst.shape[0]} frames, payloads {k}")
    if (h, w) != (decoder.height, decoder.width):
        raise ValueError(f"dst frames of {h} x {w}, the stream's are "
                         f"{decoder.height} x {decoder.width}")
    if not k:
        return 0
    layout = decoder.layout
    if layout:
        _mjpeg()   # the YUV layouts' converter
    plane_bytes = frame_bytes(layout, h, w) if layout else 0
    if layout and (planes is None or planes.size < k * plane_bytes):
        planes = np.empty(k * plane_bytes, np.uint8)
    if layout:
        _u8_buffer(planes, "planes", writable=True)
    flats = [np.frombuffer(p, np.uint8) for p in payloads]
    ptrs, sizes = _ptr_array(flats)
    rcs, slices = (ctypes.c_int * k)(), (ctypes.c_int * k)()
    lib.clt_ffv1_decode_batch(
        decoder._handle, ptrs, sizes, k, _as_u8_ptr(dst),
        None if planes is None else _as_u8_ptr(planes), plane_bytes,
        threads or os.cpu_count() or 1, rcs, slices)
    first = decoder.frames
    for i, rc in enumerate(rcs):
        if rc != 0:
            at = f"slice {slices[i]}: " if slices[i] >= 0 else \
                "the last slice: " if rc == -2 else ""
            raise ValueError(f"ffv1_decode_bgr_batch: frame {first + i}: "
                             f"{at}{_FFV1_REASONS.get(rc, f'code {rc}')}")
    decoder.frames += k
    if layout:
        raw_decode_bgr_batch([planes[i * plane_bytes:(i + 1) * plane_bytes]
                              for i in range(k)], dst, layout,
                             threads=threads, first_frame=first,
                             matrix=decoder.matrix)
    return k


_pool = None


def _thread_pool():
    """The frame decoders' thread pool (one thread a CPU, made on first
    use): Python's ``zlib`` releases the GIL while it inflates."""
    global _pool
    if _pool is None:
        from concurrent.futures import ThreadPoolExecutor
        _pool = ThreadPoolExecutor(_NTHREADS, "clt-frames")
    return _pool


def _ptr_array(arrays):
    k = len(arrays)
    return ((ctypes.c_void_p * k)(*[a.ctypes.data for a in arrays]),
            (ctypes.c_size_t * k)(*[a.size for a in arrays]))


def png_decode_bgr_batch(payloads, dst: np.ndarray,
                         info: Optional["png_plain.PngInfo"] = None,
                         threads: Optional[int] = None,
                         first_frame: int = 0) -> int:
    """Decode PNG file i (``payloads[i]``, a frame chunk of a PNG AVI) into
    ``dst[i]`` ((k, H, W, 3) BGR uint8), giving the frame
    ``cv2.VideoCapture`` gives for it (``native/png_plain.py`` has each
    layout's rule).  Every frame's ``IHDR`` must be ``info`` (default: the
    first frame's) and its geometry ``dst``'s.  Chunks are read and
    inflated on the frame thread pool, then unfiltered and converted by
    ``png.cpp`` on up to ``threads`` threads (default: every CPU).
    Returns k; raises ValueError naming the first frame (from
    ``first_frame``) that is refused or wrong (a layout it does not read,
    no PNG, an ``IHDR`` not ``info``, a wrong CRC, a corrupt or short zlib
    stream, a filter type past 4, a palette index past ``PLTE``), after
    every frame was tried; a
    RuntimeError where ``png.cpp`` did not build."""
    import zlib
    lib = _require(_load_decoder("_png"), "_png")
    _check_frames(dst, 4, "(k, H, W, 3)")
    k = len(payloads)
    if dst.shape[0] != k:
        raise ValueError(f"dst holds {dst.shape[0]} frames, payloads {k}")
    if not k:
        return 0
    if info is None:
        info = png_plain.read_header(payloads[0])

    def fail(i: int, why) -> ValueError:
        return ValueError(f"png_decode_bgr_batch: frame {first_frame + i}: "
                          f"{why}")
    if info is None:
        raise fail(0, "not a PNG file")
    why = png_plain.unsupported(info)
    if why:
        raise fail(0, f"a PNG layout the decoder does not read: {why}")
    if (info.height, info.width) != dst.shape[1:3]:
        raise fail(0, f"a {info.height} x {info.width} image, not "
                      f"{dst.shape[1]} x {dst.shape[2]}")

    def prepare(i: int):
        try:
            frame = png_plain.read_frame(payloads[i])
            if frame.info != info:
                raise png_plain.PngError(
                    f"its IHDR ({png_plain.layout_name(frame.info)}, "
                    f"{frame.info.height} x {frame.info.width}) differs "
                    f"from the stream's ({png_plain.layout_name(info)}, "
                    f"{info.height} x {info.width})")
            try:
                raw = zlib.decompress(frame.idat)
            except zlib.error as exc:
                raise png_plain.PngError(
                    f"a corrupt zlib stream ({exc})") from exc
        except png_plain.PngError as exc:
            return exc
        palette = np.zeros((0, 3), np.uint8) if frame.palette is None \
            else np.ascontiguousarray(frame.palette)
        return np.frombuffer(raw, np.uint8), palette
    prepared = list(_thread_pool().map(prepare, range(k)))
    for i, got in enumerate(prepared):
        if isinstance(got, Exception):
            raise fail(i, got) from got
    ptrs, sizes = _ptr_array([raw for raw, _ in prepared])
    palettes = (ctypes.c_void_p * k)(*[p.ctypes.data for _, p in prepared])
    entries = (ctypes.c_int * k)(*[len(p) for _, p in prepared])
    rcs = (ctypes.c_int * k)()
    lib.clt_png_decode_bgr_batch(
        ptrs, sizes, k, _as_u8_ptr(dst), info.height, info.width,
        info.bit_depth, info.color_type, info.interlace, palettes, entries,
        threads or os.cpu_count() or 1, rcs)
    reasons = {-1: "the zlib stream ends before the image (short scanlines)",
               -2: "a filter type past 4",
               -3: "a palette index past the PLTE entries",
               -4: "a PNG layout the decoder does not read"}
    for i, rc in enumerate(rcs):
        if rc != 0:
            raise fail(i, reasons.get(rc, f"return code {rc}"))
    return k


def huffyuv_decode_bgr_batch(payloads, dst: np.ndarray,
                             params: "huffyuv_plain.HuffyuvParams",
                             threads: Optional[int] = None,
                             first_frame: int = 0,
                             planes: Optional[np.ndarray] = None) -> int:
    """Decode HuffYUV frame chunk i of a stream of ``params``
    (``huffyuv_plain.params``) into ``dst[i]`` ((k, H, W, 3) BGR uint8),
    giving the frame ``cv2.VideoCapture`` gives for it: ``huffyuv.cpp`` on
    up to ``threads`` threads (default: every CPU), RGB straight into
    ``dst``, YUV into planes (``planes``: a reusable uint8 buffer of at
    least k frames' planes) that the rawvideo converter (``jpeg.cpp``)
    turns into BGR.  Returns k; raises ValueError for a layout it does not
    read, or naming the first frame (from ``first_frame``) whose codes run
    past its chunk or are in no table, after every frame was tried; a
    RuntimeError where a library did not build."""
    lib = _require(_load_decoder("_huffyuv"), "_huffyuv")
    _check_frames(dst, 4, "(k, H, W, 3)")
    k, (h, w) = len(payloads), dst.shape[1:3]
    if dst.shape[0] != k:
        raise ValueError(f"dst holds {dst.shape[0]} frames, payloads {k}")
    layout = huffyuv_plain.yuv_layout(params)
    if layout:
        _mjpeg()   # the YUV layouts' converter
    plane_bytes = frame_bytes(layout, h, w) if layout else 0
    if layout and (planes is None or planes.size < k * plane_bytes):
        planes = np.empty(k * plane_bytes, np.uint8)
    if layout:
        _u8_buffer(planes, "planes", writable=True)
    flats = [np.frombuffer(p, np.uint8) for p in payloads]
    ptrs, sizes = _ptr_array(flats)
    lengths = np.ascontiguousarray(params.lengths, np.uint8)
    codes = np.ascontiguousarray(params.codes, np.uint32)
    if lengths.shape != (3, 256) or codes.shape != (3, 256):
        raise ValueError("a HuffYUV stream needs (3, 256) code lengths and "
                         "codes")
    rcs = (ctypes.c_int * k)()
    lib.clt_huffyuv_decode_batch(
        ptrs, sizes, k, _as_u8_ptr(dst),
        None if planes is None else _as_u8_ptr(planes), plane_bytes, h, w,
        params.bpp, params.predictor, int(params.decorrelate),
        int(params.interlaced), _as_u8_ptr(lengths),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        threads or os.cpu_count() or 1, rcs)
    reasons = {-1: "the codes run past the end of the chunk",
               -2: "bits that are no code of the stream's tables",
               -4: "a HuffYUV layout the decoder does not read ("
                   + huffyuv_plain.layout_name(params) + f", {h} x {w})"}
    for i, rc in enumerate(rcs):
        if rc != 0:
            raise ValueError(f"huffyuv_decode_bgr_batch: frame "
                             f"{first_frame + i}: "
                             + reasons.get(rc, f"return code {rc}"))
    if layout:
        raw_decode_bgr_batch([planes[i * plane_bytes:(i + 1) * plane_bytes]
                              for i in range(k)], dst, layout,
                             threads=threads, first_frame=first_frame)
    return k


_UTVIDEO_LAYOUTS = ("gbrp", "gbrap", "yuv420p", "yuv422p", "yuv444p")
_UTVIDEO_REASONS = {
    -1: "it runs past the chunk",
    -2: "its end offset decreases or runs past the chunk",
    -3: "code lengths FFmpeg's table builder refuses",
    -4: "bits that are no code of the plane's table",
    -5: "its codes run past the slice",
    -6: "an empty slice in a coded plane"}


def utvideo_decode_bgr_batch(payloads, dst: np.ndarray,
                             params: "utvideo_plain.UtvideoParams",
                             planes: Optional[np.ndarray] = None,
                             threads: Optional[int] = None,
                             first_frame: int = 0) -> int:
    """Decode Ut Video frame chunk i of a stream of ``params``
    (``utvideo_plain.params``) into ``dst[i]`` ((k, H, W, 3) BGR uint8),
    giving the frame ``cv2.VideoCapture`` gives for it: ``utvideo.cpp``
    a frame a thread on up to ``threads`` threads (default: every CPU),
    RGB straight into ``dst``, YUV into planes (``planes``: a reusable
    uint8 buffer of at least k frames' planes) that the rawvideo converter
    (``jpeg.cpp``) turns into BGR with the stream's matrix.  Returns k;
    raises ValueError for a layout it does not read, or naming the first
    frame (from ``first_frame``), plane and slice that is damaged (planes
    or slices past the chunk, refused code lengths, bits that are no code,
    codes past their slice, an empty coded slice), after every frame was
    tried; a RuntimeError where a library did not build."""
    lib = _require(_load_decoder("_utvideo"), "_utvideo")
    _check_frames(dst, 4, "(k, H, W, 3)")
    k, (h, w) = len(payloads), dst.shape[1:3]
    if dst.shape[0] != k:
        raise ValueError(f"dst holds {dst.shape[0]} frames, payloads {k}")
    why = utvideo_plain.size_unsupported(params, h, w)
    if why:
        raise ValueError(f"utvideo_decode_bgr_batch: a Ut Video layout the "
                         f"decoder does not read: {why}")
    layout = utvideo_plain.yuv_layout(params)
    if layout:
        _mjpeg()   # the YUV layouts' converter
    plane_bytes = frame_bytes(layout, h, w) if layout else 0
    if layout and (planes is None or planes.size < k * plane_bytes):
        planes = np.empty(k * plane_bytes, np.uint8)
    if layout:
        _u8_buffer(planes, "planes", writable=True)
    flats = [np.frombuffer(p, np.uint8) for p in payloads]
    ptrs, sizes = _ptr_array(flats)
    rcs, wheres = (ctypes.c_int * k)(), (ctypes.c_int * k)()
    lib.clt_utvideo_decode_batch(
        ptrs, sizes, k, _as_u8_ptr(dst),
        _as_u8_ptr(planes) if layout else None, plane_bytes, h, w,
        _UTVIDEO_LAYOUTS.index(params.layout), params.slices,
        int(params.interlaced), threads or os.cpu_count() or 1, rcs, wheres)
    for i, rc in enumerate(rcs):
        if rc != 0:
            at, slc = wheres[i] >> 16, wheres[i] & 0xFFFF
            where = "the frame information" if wheres[i] < 0 else \
                f"plane {at}" if slc == 0xFFFF else f"plane {at}, slice {slc}"
            raise ValueError(f"utvideo_decode_bgr_batch: frame "
                             f"{first_frame + i}: {where}: "
                             + _UTVIDEO_REASONS.get(rc, f"return code {rc}"))
    if layout:
        raw_decode_bgr_batch([planes[i * plane_bytes:(i + 1) * plane_bytes]
                              for i in range(k)], dst, layout,
                             threads=threads, first_frame=first_frame,
                             matrix=utvideo_plain.matrix(params))
    return k


_LAGARITH_REASONS = {
    -1: "a chunk shorter than its frame header",
    -2: "its offset is past the chunk",
    -3: "a probability header FFmpeg refuses",
    -4: "data that end before the plane does",
    -5: "an escape byte FFmpeg refuses",
    -6: "a zero run longer than its row or plane"}


def lagarith_decode_bgr_batch(payloads, dst: np.ndarray,
                              planes: Optional[np.ndarray] = None,
                              threads: Optional[int] = None,
                              first_frame: int = 0) -> int:
    """Decode Lagarith frame chunk i into ``dst[i]`` ((k, H, W, 3) BGR
    uint8), giving the frame ``cv2.VideoCapture`` gives for it:
    ``lagarith.cpp`` decodes the planes of all k frames side by side, a
    plane a thread, on up to ``threads`` threads (default: every CPU), RGB
    and solid frames straight into ``dst``, YUY2 and YV12 frames into
    planes (``planes``: a reusable uint8 buffer of at least k yuv422p
    frames) that the rawvideo converter (``jpeg.cpp``) turns into BGR.
    Every frame carries its own type, so one batch may mix them.  Returns
    k; raises ValueError naming the first frame (from ``first_frame``) of
    a type FFmpeg refuses, or the first damaged one and its plane, after
    every frame was tried; a RuntimeError where a library did not
    build."""
    lib = _require(_load_decoder("_lagarith"), "_lagarith")
    _check_frames(dst, 4, "(k, H, W, 3)")
    k, (h, w) = len(payloads), dst.shape[1:3]
    if dst.shape[0] != k:
        raise ValueError(f"dst holds {dst.shape[0]} frames, payloads {k}")
    flats = [np.frombuffer(p, np.uint8) for p in payloads]
    kinds = [lagarith_plain.frame_kind(int(f[0])) if f.size else "bgr"
             for f in flats]
    yuv = any(kind != "bgr" for kind in kinds)
    plane_bytes = frame_bytes("yuv422p", h, w) if yuv else 0
    if yuv:
        _mjpeg()   # the YUV layouts' converter
        if planes is None or planes.size < k * plane_bytes:
            planes = np.empty(k * plane_bytes, np.uint8)
        _u8_buffer(planes, "planes", writable=True)
    ptrs, sizes = _ptr_array(flats)
    rcs, wheres = (ctypes.c_int * k)(), (ctypes.c_int * k)()
    lib.clt_lagarith_decode_batch(
        ptrs, sizes, k, _as_u8_ptr(dst), _as_u8_ptr(planes) if yuv else None,
        plane_bytes, h, w, threads or os.cpu_count() or 1, rcs, wheres)
    for i, rc in enumerate(rcs):
        if rc == 0:
            continue
        at = f"lagarith_decode_bgr_batch: frame {first_frame + i}: "
        if rc == -7:
            t = int(flats[i][0])
            raise ValueError(at + (lagarith_plain.unsupported(t, h, w) or
                                   "a frame the decoder does not read"))
        where = f"plane {wheres[i]}: " if wheres[i] >= 0 else ""
        raise ValueError(at + where + _LAGARITH_REASONS.get(
            rc, f"return code {rc}"))
    a = 0
    while a < k:
        b = a + 1
        while b < k and kinds[b] == kinds[a]:
            b += 1
        layout = kinds[a]
        if layout != "bgr":
            raw_decode_bgr_batch(
                [planes[i * plane_bytes:(i + 1) * plane_bytes]
                 for i in range(a, b)], dst[a:b], layout, threads=threads,
                first_frame=first_frame + a)
        a = b
    return k


# mpeg4.cpp's return codes
_MPEG4_REASONS = {
    -1: "bits FFmpeg fails to decode (it conceals the frame)",
    -2: "the data end inside it",
    -3: "a video packet header FFmpeg refuses (or a packet that does not "
        "start at the next macroblock)",
    -4: "an earlier frame failed to decode (the references are lost)"}


class Mpeg4Decoder:
    """The native decoder of one MPEG-4 Part 2 stream (``tag``: the codec
    tag FFmpeg's demuxer sets, which its bug detection reads: an AVI's
    fourcc, an MP4 sample entry's, none for Matroska's ``V_MPEG4/*``;
    ``extradata``: the ``strf`` bytes after the BITMAPINFOHEADER, the
    ``esds`` DecoderSpecificInfo, the CodecPrivate) of ``height`` x
    ``width`` frames; ``matrix``, where the container's colour tags name
    one, converts the frames of a VOL that names none.  Python reads each
    chunk's headers (``mpeg4_plain.Stream``: the VOL, user data, the VOP
    header and times, a packed bitstream's pending VOP and the refusals);
    ``mpeg4.cpp`` keeps the prediction state, the two references and the
    latest one's vectors from one :func:`mpeg4_decode_bgr_batch` call to
    the next, so the decoder takes the stream's chunks in order, from its
    first.  ``frames`` counts the frames it output.  Raises RuntimeError
    where the library did not build."""

    def __init__(self, tag: str, extradata: bytes, height: int, width: int):
        self._lib = _require(_load_decoder("_mpeg4"), "_mpeg4")
        _mjpeg()   # the planes' converter
        self._handle = None
        self.stream = mpeg4_plain.Stream(tag, extradata, height, width)
        self.height, self.width = height, width
        self.matrix: Optional[str] = None
        self.frames = 0
        # the latest I- or P-VOP's planes (a stream with B-frames outputs
        # it when the next one comes, or at the end)
        self.held: Optional[np.ndarray] = None
        self.failed: Optional[str] = None        # why a call failed

    def _open(self) -> None:
        v = self.stream.vol
        self._handle = self._lib.clt_mpeg4_new(v.height, v.width,
                                               int(v.resync_marker),
                                               v.time_increment_bits)
        if not self._handle:
            raise ValueError(f"an MPEG-4 stream of {v.width} x {v.height} "
                             "the decoder does not take")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.clt_mpeg4_free(self._handle)
            self._handle = None


_NO_MATRIX = (0,) * 64


def mpeg4_decode_bgr_batch(payloads, dst: np.ndarray, decoder: Mpeg4Decoder,
                           planes: Optional[np.ndarray] = None,
                           threads: Optional[int] = None) -> int:
    """Decode the next MPEG-4 Part 2 chunks of ``decoder``'s stream into
    ``dst`` ((k, H, W, 3) BGR uint8, k >= ``len(payloads)``), giving the
    frames ``cv2.VideoCapture`` gives for them, in its order: ``mpeg4.cpp``
    on up to ``threads`` threads (default: every CPU) into yuv420p planes
    (``planes``: a reusable uint8 buffer of at least k ``i420_left``
    frames), which the rawvideo converter (``jpeg.cpp``) turns into BGR.
    Returns the number of frames written: an N-VOP, a skipped B-VOP or a
    drop chunk gives none, and so does a stream with B-frames' first I-VOP
    (it comes out with the next I- or P-VOP, each one after the one before
    it, the last at :func:`mpeg4_flush`; empty chunks the caller drops, as
    the AVI demuxer does).  Raises ValueError naming the frame (the chunk's
    index in the stream) that the decoder refuses (a feature
    ``mpeg4_plain.unsupported`` names) or that does not decode, and the
    macroblock where it fails; after a failure the decoder refuses every
    call.  RuntimeError where a library did not build."""
    _check_frames(dst, 4, "(k, H, W, 3)")
    st = decoder.stream
    k, (h, w) = len(payloads), dst.shape[1:3]
    if dst.shape[0] < k:
        raise ValueError(f"dst holds {dst.shape[0]} frames, payloads {k}")
    if (h, w) != (decoder.height, decoder.width):
        raise ValueError(f"dst frames of {h} x {w}, the stream's are "
                         f"{decoder.height} x {decoder.width}")
    if decoder.failed:
        raise ValueError(f"mpeg4_decode_bgr_batch: {decoder.failed}")
    jobs = []
    for p in payloads:
        index = st.chunks
        try:
            fh = st.next(bytes(p))
        except mpeg4_plain.Mpeg4Error as exc:
            decoder.failed = str(exc)
            raise ValueError(f"mpeg4_decode_bgr_batch: {exc}") from None
        if fh.kind in "IPB":
            v = fh.vop
            jobs.append((fh, index, (
                "IPB".index(fh.kind), v.quant, v.fcode, v.bcode, v.rounding,
                v.dc_threshold, int(fh.edge), int(fh.dc_clip), int(fh.xvid),
                fh.pb, fh.pp, int(fh.intra_matrix is not None)),
                (fh.intra_matrix or _NO_MATRIX) +
                (fh.inter_matrix or _NO_MATRIX)))
    n = len(jobs)
    if not n:
        return 0
    if decoder._handle is None:
        decoder._open()
    plane_bytes = frame_bytes("i420_left", h, w)
    if planes is None or planes.size < n * plane_bytes:
        planes = np.empty(n * plane_bytes, np.uint8)
    _u8_buffer(planes, "planes", writable=True)
    flats = [np.frombuffer(j[0].data, np.uint8) for j in jobs]
    ptrs, sizes = _ptr_array(flats)
    bits = (ctypes.c_size_t * n)(*[j[0].bit for j in jobs])
    params = np.array([j[2] for j in jobs], np.int32)
    matrices = np.array([j[3] for j in jobs], np.int32)
    rcs, wheres = (ctypes.c_int * n)(), (ctypes.c_int * n)()
    decoder._lib.clt_mpeg4_decode_batch(
        decoder._handle, ptrs, sizes, bits,
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        matrices.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n,
        _as_u8_ptr(planes), plane_bytes, threads or os.cpu_count() or 1,
        rcs, wheres)
    for i, rc in enumerate(rcs):
        if rc != 0:
            mbw = (w + 15) // 16
            where = f"macroblock ({wheres[i] % mbw}, {wheres[i] // mbw}): " \
                if wheres[i] >= 0 else ""
            decoder.failed = f"frame {jobs[i][1]}: {where}" + \
                _MPEG4_REASONS.get(rc, f"return code {rc}")
            raise ValueError(f"mpeg4_decode_bgr_batch: {decoder.failed}")
    # FFmpeg's order: a B-VOP at once, an I- or P-VOP at once (low delay)
    # or the one before it now ("last")
    outs, held = [], decoder.held
    for i, (fh, _, _, _) in enumerate(jobs):
        slot = planes[i * plane_bytes:(i + 1) * plane_bytes]
        if fh.output == "self":
            outs.append(slot)
        elif fh.output == "last":
            outs.append(held)
        if fh.kind != "B":
            held = slot
    if outs:
        raw_decode_bgr_batch(outs, dst[:len(outs)], "i420_left",
                             threads=threads, first_frame=decoder.frames,
                             matrix=mpeg4_plain.matrix_name(st.vol,
                                                            decoder.matrix))
    if held is not decoder.held:
        decoder.held = held.copy()
    decoder.frames += len(outs)
    return len(outs)


def mpeg4_flush(decoder: Mpeg4Decoder, dst: np.ndarray) -> int:
    """At the stream's end: where FFmpeg outputs its last I- or P-VOP then
    (a stream with B-frames' delay held it back; a stream that ended with
    an N-VOP repeats it), it goes to ``dst[0]`` and 1 is returned, else
    0."""
    if not decoder.stream.flush() or decoder.held is None:
        return 0
    raw_decode_bgr_batch([decoder.held], dst[:1], "i420_left",
                         first_frame=decoder.frames,
                         matrix=mpeg4_plain.matrix_name(decoder.stream.vol,
                                                        decoder.matrix))
    decoder.frames += 1
    return 1


def tiff_available() -> bool:
    """True when the native TIFF codec built (or was built) and loaded."""
    return _load_decoder("_tiff") is not None


def _tiff() -> ctypes.CDLL:
    return _require(_load_decoder("_tiff"), "_tiff")


def _u8_buffer(arr: np.ndarray, name: str, writable: bool = False):
    if arr.dtype != np.uint8 or arr.ndim != 1 or \
            not arr.flags.c_contiguous or (writable and
                                           not arr.flags.writeable):
        raise ValueError(f"{name} must be a {'writable ' * writable}"
                         "C-contiguous 1-D uint8 array")
    return _as_u8_ptr(arr)


def _u64(values, name: str) -> np.ndarray:
    arr = np.ascontiguousarray(values, np.uint64)
    if arr.ndim != 1:
        raise ValueError(f"{name} must be 1-D")
    return arr


def _check_ranges(offsets, sizes, total: int, name: str) -> None:
    if offsets.shape != sizes.shape:
        raise ValueError(f"{name}: offsets and sizes differ in length")
    if offsets.size and int((offsets + sizes).max()) > total:
        raise ValueError(f"{name}: a chunk reaches past the buffer's "
                         f"{total} bytes")


def _decode_chunks(fn, name: str, src: np.ndarray, offsets, counts,
                   dst: np.ndarray, dst_offsets, dst_sizes) -> np.ndarray:
    src_p = _u8_buffer(src, "src")
    dst_p = _u8_buffer(dst, "dst", writable=True)
    offsets, counts = _u64(offsets, "offsets"), _u64(counts, "counts")
    dst_offsets = _u64(dst_offsets, "dst_offsets")
    dst_sizes = _u64(dst_sizes, "dst_sizes")
    if offsets.shape != counts.shape:
        raise ValueError("offsets and counts differ in length")
    _check_ranges(dst_offsets, dst_sizes, dst.size, "dst")
    if dst_offsets.shape != offsets.shape:
        raise ValueError("dst_offsets and offsets differ in length")
    got = np.empty(offsets.size, np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    fn(src_p, src.size, offsets.ctypes.data_as(u64p),
       counts.ctypes.data_as(u64p), offsets.size, dst_p,
       dst_offsets.ctypes.data_as(u64p), dst_sizes.ctypes.data_as(u64p),
       got.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _NTHREADS)
    bad = np.flatnonzero(got < 0)
    if bad.size:
        k = int(bad[0])
        reason = {-1: f"corrupt {name} data", -2: "decodes to more than "
                  f"{int(dst_sizes[k])} bytes", -3: "lies outside the file"}
        raise ValueError(f"{name} chunk {k} {reason[int(got[k])]}")
    return got


def lzw_decode_chunks(src: np.ndarray, offsets, counts, dst: np.ndarray,
                      dst_offsets, dst_sizes) -> np.ndarray:
    """Decode TIFF-LZW chunks of the file image ``src`` (chunk i: bytes
    ``offsets[i]`` to ``offsets[i] + counts[i]``) into ``dst`` (chunk i at
    ``dst_offsets[i]``, room for ``dst_sizes[i]`` bytes), on all threads.
    Returns each chunk's decoded length (int64); raises ValueError for a
    corrupt chunk, one that decodes to more than its room, or one outside
    the file."""
    return _decode_chunks(_tiff().clt_lzw_decode_chunks, "LZW", src,
                          offsets, counts, dst, dst_offsets, dst_sizes)


def packbits_decode_chunks(src: np.ndarray, offsets, counts,
                           dst: np.ndarray, dst_offsets,
                           dst_sizes) -> np.ndarray:
    """Decode PackBits chunks (TIFF compression 32773) as
    ``lzw_decode_chunks`` decodes LZW ones.  As in libtiff, output past a
    chunk's room is dropped, so a length below ``dst_sizes[i]`` is the only
    sign of a bad chunk (it ran out of data); raises ValueError for a
    chunk outside the file."""
    return _decode_chunks(_tiff().clt_packbits_decode_chunks, "PackBits",
                          src, offsets, counts, dst, dst_offsets, dst_sizes)


_CCITT_REASONS = {-1: "a bad code or a row of the wrong length",
                  -2: "more rows than its room", -3: "lies outside the file",
                  -4: "data that end inside a row",
                  -5: "a row without its EOL"}


def ccitt_decode_chunks(src: np.ndarray, offsets, counts, dst: np.ndarray,
                        dst_offsets, dst_sizes, rows, width: int,
                        compression: int, t4_options: int = 0) -> np.ndarray:
    """Decode CCITT chunks of the file image ``src`` (chunk i: bytes
    ``offsets[i]`` to ``offsets[i] + counts[i]``, ``rows[i]`` rows of
    ``width`` pixels) into packed rows, 1 for black, each padded to a
    byte (chunk i at ``dst_offsets[i]``, room for ``dst_sizes[i]``
    bytes), on all threads: compression 2 (Modified Huffman), 3 (T.4,
    ``t4_options`` its T4Options: bit 0 two-dimensional rows) or 4
    (T.6).  Returns each chunk's bytes; raises ValueError naming the
    first chunk that does not decode cleanly (where libtiff would conceal
    an error), as ``tiff_plain.ccitt_decode`` raises."""
    lib = _tiff()
    src_p = _u8_buffer(src, "src")
    dst_p = _u8_buffer(dst, "dst", writable=True)
    offsets, counts = _u64(offsets, "offsets"), _u64(counts, "counts")
    dst_offsets = _u64(dst_offsets, "dst_offsets")
    dst_sizes = _u64(dst_sizes, "dst_sizes")
    rows = np.ascontiguousarray(rows, np.int32)
    if not offsets.shape == counts.shape == dst_offsets.shape == rows.shape:
        raise ValueError("offsets, counts, dst_offsets and rows differ in "
                         "length")
    _check_ranges(dst_offsets, dst_sizes, dst.size, "dst")
    got = np.empty(offsets.size, np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.clt_ccitt_decode_chunks(
        src_p, src.size, offsets.ctypes.data_as(u64p),
        counts.ctypes.data_as(u64p), offsets.size, dst_p,
        dst_offsets.ctypes.data_as(u64p), dst_sizes.ctypes.data_as(u64p),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), width,
        compression, t4_options,
        got.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _NTHREADS)
    bad = np.flatnonzero(got < 0)
    if bad.size:
        k = int(bad[0])
        raise ValueError(f"CCITT chunk {k}: {_CCITT_REASONS[int(got[k])]}")
    return got


def lzw_encode_chunks(src: np.ndarray, offsets, sizes) -> list:
    """TIFF-LZW encode chunks of ``src`` (chunk i: ``sizes[i]`` bytes at
    ``offsets[i]``), on all threads, as libtiff's encoder codes them.
    Returns one uint8 array per chunk."""
    lib = _tiff()
    src_p = _u8_buffer(src, "src")
    offsets, sizes = _u64(offsets, "offsets"), _u64(sizes, "sizes")
    _check_ranges(offsets, sizes, src.size, "src")
    # at most one code of 12 bits per byte, a Clear per 3836 codes, and
    # the Clear, last code and EOI
    caps = sizes * 3 // 2 + sizes // 2048 + 16
    dst_offsets = np.zeros_like(caps)
    if caps.size:
        np.cumsum(caps[:-1], out=dst_offsets[1:])
    dst = np.empty(int(caps.sum()), np.uint8)
    out = np.empty_like(sizes)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.clt_lzw_encode_chunks(
        src_p, offsets.ctypes.data_as(u64p), sizes.ctypes.data_as(u64p),
        sizes.size, _as_u8_ptr(dst), dst_offsets.ctypes.data_as(u64p),
        caps.ctypes.data_as(u64p), out.ctypes.data_as(u64p), _NTHREADS)
    if np.any(out > caps):
        raise RuntimeError("LZW output exceeded its bound")
    return [dst[int(o):int(o) + int(n)] for o, n in zip(dst_offsets, out)]


def predictor_undo(data: np.ndarray, rows: int, samples: int, spp: int,
                   size: int, predictor: int, swap: bool) -> None:
    """Undo TIFF predictor ``predictor`` (1 none, 2 horizontal at 8, 16,
    32 or 64 bits, 3 floating point at 32/64 bits) in place over ``rows``
    rows of ``samples`` samples of ``size`` bytes in the uint8 buffer
    ``data``; ``swap``: the samples are big-endian in the file (they end
    in the host's order)."""
    lib = _tiff()
    ptr = _u8_buffer(data, "data", writable=True)
    if rows * samples * size > data.size:
        raise ValueError(f"{rows} rows of {samples} samples of {size} bytes "
                         f"exceed the buffer's {data.size} bytes")
    if lib.clt_predictor_undo(ptr, rows, samples, spp, size, predictor,
                              int(swap), _NTHREADS) != 0:
        raise ValueError(f"Predictor={predictor} is not supported at "
                         f"{8 * size}-bit samples")


def predictor_apply(data: np.ndarray, rows: int, samples: int, spp: int,
                    size: int) -> None:
    """Apply horizontal differencing (TIFF predictor 2) in place, 8/16-bit
    samples in the host's order."""
    lib = _tiff()
    ptr = _u8_buffer(data, "data", writable=True)
    if rows * samples * size > data.size:
        raise ValueError(f"{rows} rows of {samples} samples of {size} bytes "
                         f"exceed the buffer's {data.size} bytes")
    if lib.clt_predictor_apply(ptr, rows, samples, spp, size,
                               _NTHREADS) != 0:
        raise ValueError(f"Predictor=2 is not applied at {8 * size}-bit "
                         "samples")


def _as_u8_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def u8_to_f32(arr: np.ndarray, scale: float) -> np.ndarray:
    """arr.astype(f32) * scale, threaded natively when available."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    lib = _load()
    if lib is None:
        return arr.astype(np.float32) * np.float32(scale)
    out = np.empty(arr.shape, np.float32)
    lib.clt_u8_to_f32(_as_u8_ptr(arr),
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      arr.size, scale, _NTHREADS)
    return out


def u8_hwc_to_cfirst_f32(arr: np.ndarray, scale: float) -> np.ndarray:
    """(..., C) interleaved uint8 -> (C, pixels) planar float32 with
    normalization."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    channels = arr.shape[-1]
    pixels = arr.size // channels
    lib = _load()
    if lib is None:
        flat = arr.reshape(pixels, channels).astype(np.float32) * \
            np.float32(scale)
        return np.ascontiguousarray(flat.T)
    out = np.empty((channels, pixels), np.float32)
    lib.clt_u8_hwc_to_cfirst_f32(
        _as_u8_ptr(arr), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pixels, channels, scale, _NTHREADS)
    return out


def welford_update_batch_u8(frames: np.ndarray, mean: np.ndarray,
                            m2: np.ndarray, scale: float,
                            start_count: int) -> int:
    """In-place Welford over a (B, ...) uint8 frame batch into float64
    ``mean`` and ``m2``; returns the new frame count.  Operation order
    matches video_processing.py:206-208."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    batch = frames.shape[0]
    n = frames.size // batch
    for name, acc in (("mean", mean), ("m2", m2)):
        if acc.size != n or acc.dtype != np.float64 or \
                not acc.flags.c_contiguous:
            raise ValueError(f"{name} must be C-contiguous float64 of {n} "
                             "elements, one frame's")
    lib = _load()
    if lib is None:
        count = start_count
        fm = mean.reshape(-1)
        f2 = m2.reshape(-1)
        for b in range(batch):
            count += 1
            x = frames[b].reshape(-1).astype(np.float64) * scale
            delta = x - fm
            fm += delta / count
            f2 += delta * (x - fm)
        return count
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.clt_welford_update_batch_u8(
        _as_u8_ptr(frames), mean.ctypes.data_as(f64p),
        m2.ctypes.data_as(f64p), batch, n, scale, start_count, _NTHREADS)
    return start_count + batch


def narrow_f16(values) -> np.ndarray:
    """float64 values narrowed to float16 by the native routine the wire
    finalize stores its std with (round to nearest, ties to even; the
    NumPy cast where the library is unavailable)."""
    x = np.ascontiguousarray(values, np.float64)
    lib = _load()
    if lib is None:
        return x.astype(np.float16)
    out = np.empty(x.shape, np.uint16)
    lib.clt_f64_to_f16(x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                       x.size)
    return out.view(np.float16)


def accum_moments_u8(frames: np.ndarray, sum_: np.ndarray,
                     sumsq: np.ndarray) -> None:
    """In-place exact integer accumulation of per-element sum and sum of
    squares over a (B, ...) uint8 frame batch (tiled native kernel; NumPy
    reduction fallback)."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    batch = frames.shape[0]
    if batch == 0:
        return
    n = frames.size // batch
    if sum_.size != n or sumsq.size != n or \
            sum_.dtype != np.uint64 or sumsq.dtype != np.uint64 or \
            not sum_.flags.c_contiguous or not sumsq.flags.c_contiguous:
        raise ValueError(f"accumulators must be C-contiguous uint64 of "
                         f"{n} elements, one frame's")
    lib = _load()
    if lib is None:
        flat = frames.reshape(batch, -1)
        sum_.reshape(-1)[:] += flat.sum(axis=0, dtype=np.uint64)
        sumsq.reshape(-1)[:] += (flat.astype(np.uint32) ** 2).sum(
            axis=0, dtype=np.uint64)
        return
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.clt_accum_moments_u8(_as_u8_ptr(frames), batch, n,
                             sum_.ctypes.data_as(u64p),
                             sumsq.ctypes.data_as(u64p), _NTHREADS)


class HostMoments:
    """Exact streaming first/second moments of a raw uint8 frame stream.

    Replaces the running float Welford update for DN data: sums and sums of
    squares accumulate as exact integers (zero rounding error at any frame
    count), and finalization recovers the same statistics as the reference's
    frame-by-frame loop (modules/video_processing.py:206-215):

        mean = (sum / n) * scale
        M2   = (sumsq - sum^2 / n) * scale^2      == Welford M2, exactly
        std_of_mean = sqrt(M2 / (n-1)) / sqrt(n)
    """

    def __init__(self, shape, scale: float, _buffers=None):
        if _buffers is not None:
            # caller-provided accumulators (reused across runs: warm pages
            # write at memory speed, fresh ones fault); zeroed here
            self.sum, self.sumsq = _buffers
            self.sum.fill(0)
            self.sumsq.fill(0)
        else:
            self.sum = np.zeros(shape, np.uint64)
            self.sumsq = np.zeros(shape, np.uint64)
        self.count = 0
        self.scale = float(scale)

    def update(self, frames: np.ndarray) -> None:
        if frames.ndim == self.sum.ndim:
            frames = frames[None]
        accum_moments_u8(frames, self.sum, self.sumsq)
        self.count += frames.shape[0]

    def finalize(self, use_std: bool = True, dtype=np.float64, out=None
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Recover (mean, std_of_mean) from the integer accumulators.

        One fused native pass writing only the two outputs (the NumPy
        expression allocates ~8 full-frame f64 temporaries).  ``dtype``
        float32 narrows on store (arithmetic stays f64 — results are
        bit-identical to finalizing in f64 then casting).
        ``dtype=WIRE_U16F16`` (the pair ``(uint16, float16)``) writes the
        host->device wire encoding directly — u16 fixed-point mean + f16
        std — still one fused pass.  ``out=(mean, std)`` writes into
        caller-provided C-contiguous ``dtype`` arrays (std entry ignored
        when no std is produced), e.g. slices of a preassembled exposure
        stack.
        """
        n = float(self.count)
        want_std = use_std and self.count >= 2
        if isinstance(dtype, (tuple, list)):
            return self._finalize_wire(n, want_std, tuple(
                np.dtype(d) for d in dtype), out)
        dt = np.dtype(dtype)
        if out is not None:
            # shape must match exactly: the native pass writes
            # self.sum.size elements through raw pointers, so a smaller
            # out would be a silent out-of-bounds heap write
            if out[0].dtype != dt or not out[0].flags.c_contiguous or \
                    out[0].shape != self.sum.shape or \
                    (want_std and (out[1].dtype != dt
                                   or not out[1].flags.c_contiguous
                                   or out[1].shape != self.sum.shape)):
                raise ValueError("finalize out= arrays must be "
                                 f"C-contiguous {dt} of shape "
                                 f"{self.sum.shape}")
        lib = _load()
        if lib is not None and dt in (np.float32, np.float64):
            fn = (lib.clt_finalize_moments_u64 if dt == np.float64
                  else lib.clt_finalize_moments_u64_f32)
            cty = ctypes.c_double if dt == np.float64 else ctypes.c_float
            outp = ctypes.POINTER(cty)
            if out is not None:
                mean = out[0]
                std = out[1] if want_std else None
            else:
                mean = np.empty(self.sum.shape, dt)
                std = np.empty(self.sum.shape, dt) if want_std else None
            u64p = ctypes.POINTER(ctypes.c_uint64)
            fn(self.sum.ctypes.data_as(u64p),
               self.sumsq.ctypes.data_as(u64p),
               self.sum.size, ctypes.c_double(n),
               ctypes.c_double(self.scale),
               mean.ctypes.data_as(outp),
               std.ctypes.data_as(outp) if want_std else
               ctypes.cast(None, outp),
               _NTHREADS)
            return mean, std
        mean, std = self._finalize_f64(n, want_std)
        if out is not None:
            out[0][...] = mean
            mean = out[0]
            if want_std:
                out[1][...] = std
                std = out[1]
            return mean, std
        return (mean.astype(dt, copy=False),
                None if std is None else std.astype(dt, copy=False))

    def _finalize_wire(self, n: float, want_std: bool, dtypes, out):
        """Fused finalize straight into the u16+f16 wire encoding."""
        if dtypes != WIRE_U16F16:
            raise ValueError("finalize: the only supported dtype pair is "
                             f"WIRE_U16F16 (uint16, float16), got {dtypes}")
        vd, sd = dtypes
        if out is not None:
            if out[0].dtype != vd or not out[0].flags.c_contiguous or \
                    out[0].shape != self.sum.shape or \
                    (want_std and (out[1].dtype != sd
                                   or not out[1].flags.c_contiguous
                                   or out[1].shape != self.sum.shape)):
                raise ValueError("finalize out= arrays must be "
                                 f"C-contiguous ({vd}, {sd}) of shape "
                                 f"{self.sum.shape}")
        lib = _load()
        if lib is not None:
            if out is not None:
                mean = out[0]
                std = out[1] if want_std else None
            else:
                mean = np.empty(self.sum.shape, vd)
                std = np.empty(self.sum.shape, sd) if want_std else None
            u64p = ctypes.POINTER(ctypes.c_uint64)
            u16p = ctypes.POINTER(ctypes.c_uint16)
            lib.clt_finalize_moments_u64_wire(
                self.sum.ctypes.data_as(u64p),
                self.sumsq.ctypes.data_as(u64p),
                self.sum.size, ctypes.c_double(n),
                ctypes.c_double(self.scale),
                mean.ctypes.data_as(u16p),
                # the native side stores the f16 bits as uint16
                std.ctypes.data_as(u16p) if want_std else
                ctypes.cast(None, u16p),
                _NTHREADS)
            return mean, std
        # NumPy fallback: f64 finalize, then the shared wire quantizer
        mean64, std64 = self._finalize_f64(n, want_std)
        return wire_quantize_u16f16(mean64, std64, out=out)

    def _finalize_f64(self, n: float, want_std: bool):
        """The plain f64 NumPy finalize expression (fallback helper)."""
        s = self.sum.astype(np.float64)
        mean = s / n * self.scale
        std = None
        if want_std:
            m2 = (self.sumsq.astype(np.float64) - s * s / n) \
                * self.scale ** 2
            np.maximum(m2, 0.0, out=m2)
            std = np.sqrt(m2 / (n - 1.0)) / np.sqrt(n)
        return mean, std


class HostWelford:
    """Host-side streaming Welford accumulator over raw uint8 frames, in
    float64: the reference's running update (video_processing.py:206-215),
    threaded natively.  ``HostMoments`` is the exact alternative the video
    statistics use."""

    def __init__(self, shape, scale: float):
        self.mean = np.zeros(shape, np.float64)
        self.m2 = np.zeros(shape, np.float64)
        self.count = 0
        self.scale = float(scale)

    def update(self, frames: np.ndarray) -> None:
        if frames.ndim == len(self.mean.shape):
            frames = frames[None]
        self.count = welford_update_batch_u8(frames, self.mean, self.m2,
                                             self.scale, self.count)

    def finalize(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(mean, std of the mean); the std is None below two frames."""
        if self.count < 2:
            return self.mean.copy(), None
        std = np.sqrt(self.m2 / (self.count - 1)) / np.sqrt(self.count)
        return self.mean.copy(), std


class H264Decoder:
    """The native decoder of one H.264 stream (``extradata``: an avcC,
    whose NAL length size then splits the samples, or Annex B parameter
    sets, or nothing for Annex B samples).  Python reads the NAL units,
    parameter sets and slice headers and keeps the decoded picture buffer
    (``h264_plain.Stream``: the POCs, the reference marking and lists, the
    refusals); ``h264.cpp`` keeps the frame slots, the pictures in them,
    from one :func:`h264_decode_bgr_batch` call to the next, so the
    decoder takes the stream's samples in order, from its first.
    ``matrix``, where the container's colour tags name one, converts the
    frames of an SPS that names none.  ``frames`` counts the frames it
    output.  Raises RuntimeError where the library did not build."""

    def __init__(self, extradata: bytes = b""):
        self._lib = _require(_load_decoder("_h264"), "_h264")
        _mjpeg()   # the planes' converter
        self._handle = None
        self._slots = 0
        self.stream = h264_plain.Stream(extradata)
        self.matrix: Optional[str] = None
        self.frames = 0
        self.failed: Optional[str] = None        # why a call failed

    def _reserve(self, mbw: int, mbh: int, slots: int) -> None:
        if self._handle is None:
            # the slots the stream has handed out (more come as it needs
            # them: a 4K slot holds 12.4 MB of planes)
            self._slots = slots
            self._handle = self._lib.clt_h264_new(mbw, mbh, self._slots)
            if not self._handle:
                raise ValueError(f"an H.264 stream of {mbw * 16} x "
                                 f"{mbh * 16} the decoder does not take")
        elif slots > self._slots:
            self._lib.clt_h264_grow(self._handle, slots)
            self._slots = slots

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.clt_h264_free(self._handle)
            self._handle = None


def h264_decode_bgr_batch(payloads, dst: np.ndarray, decoder: H264Decoder,
                          planes: Optional[np.ndarray] = None,
                          threads: Optional[int] = None) -> int:
    """Decode the next samples of ``decoder``'s H.264 stream into ``dst``
    ((k, H, W, 3) BGR uint8, k >= ``len(payloads)``), giving the frames
    ``cv2.VideoCapture`` gives for them, in its order (each picture as it
    is decoded): ``h264.cpp`` on up to ``threads`` threads (default: every
    CPU; a GOP a thread where the batch holds several IDR pictures, the
    slices of a picture side by side, the deblocking after them) into
    yuv420p planes (``planes``: a reusable uint8 buffer of at least k
    frames), which the rawvideo converter (``jpeg.cpp``) turns into BGR.
    Returns the number of frames written (a sample of parameter sets only
    gives none).  Raises ValueError naming the frame (the sample's index in
    the stream) that the decoder refuses (a tool ``h264_plain.unsupported``
    names) or that does not decode, with the slice and the macroblock
    where it fails; after a failure the decoder refuses every call.
    RuntimeError where a library did not build."""
    _check_frames(dst, 4, "(k, H, W, 3)")
    st = decoder.stream
    k, (h, w) = len(payloads), dst.shape[1:3]
    if dst.shape[0] < k:
        raise ValueError(f"dst holds {dst.shape[0]} frames, payloads {k}")
    if decoder.failed:
        raise ValueError(f"h264_decode_bgr_batch: {decoder.failed}")
    jobs = []
    try:
        for p in payloads:
            job = st.next(bytes(p))
            if job is not None:
                if h264_plain.geometry(job.sps) != (h, w):
                    raise h264_plain.H264Error(
                        f"frame {job.index}: a picture of "
                        f"{h264_plain.geometry(job.sps)}, dst frames of "
                        f"{(h, w)}")
                jobs.append(job)
    except h264_plain.H264Error as exc:
        decoder.failed = str(exc)
        raise ValueError(f"h264_decode_bgr_batch: {exc}") from None
    n = len(jobs)
    if not n:
        st.end_batch()
        return 0
    sps = jobs[0].sps
    decoder._reserve(sps.mbw, sps.mbh, 1 + max(
        [j.pic.slot for j in jobs] + [p.slot for p in st.dpb]))
    pic = np.array([(j.pic.slot, j.chain, len(j.slices)) for j in jobs],
                   np.int32)
    slices = [(j, s) for j in jobs for s in j.slices]
    flats = [np.frombuffer(s.rbsp, np.uint8) for _, s in slices]
    ptrs = (ctypes.c_void_p * len(flats))(*[f.ctypes.data for f in flats])
    sizes = (ctypes.c_size_t * len(flats))(*[f.size for f in flats])
    ends = (ctypes.c_size_t * len(flats))(*[s.end_bit for _, s in slices])
    bits = (ctypes.c_size_t * len(flats))(
        *[s.header.data_bit for _, s in slices])
    params = np.array([j.native_params(s) for j, s in slices], np.int32)
    if params.shape[1] != decoder._lib.clt_h264_params():
        raise RuntimeError(f"h264_plain gives {params.shape[1]} slice "
                           "parameters, h264.cpp reads "
                           f"{decoder._lib.clt_h264_params()}")
    rcs, wheres = (ctypes.c_int * n)(), (ctypes.c_int * n)()
    ip = ctypes.POINTER(ctypes.c_int)
    decoder._lib.clt_h264_decode_batch(
        decoder._handle, pic.ctypes.data_as(ip), n, ptrs, sizes, ends, bits,
        params.ctypes.data_as(ip), threads or os.cpu_count() or 1, rcs,
        wheres)
    st.end_batch()
    for i, rc in enumerate(rcs):
        if rc != 0:
            decoder.failed = h264_plain.failure(jobs[i], rc, wheres[i])
            raise ValueError(f"h264_decode_bgr_batch: {decoder.failed}")
    plane_bytes = frame_bytes("i420_left", h, w)
    if planes is None or planes.size < n * plane_bytes:
        planes = np.empty(n * plane_bytes, np.uint8)
    _u8_buffer(planes, "planes", writable=True)
    top, left = h264_plain.crop_origin(sps)
    base = planes.ctypes.data
    for i, j in enumerate(jobs):
        decoder._lib.clt_h264_output(decoder._handle, j.pic.slot, top, left,
                                     h, w, base + i * plane_bytes)
        st.release(j.pic.slot)
    raw_decode_bgr_batch(
        [planes[i * plane_bytes:(i + 1) * plane_bytes] for i in range(n)],
        dst[:n], "i420_left", threads=threads, first_frame=decoder.frames,
        matrix=h264_plain.matrix_name(sps, decoder.matrix))
    decoder.frames += n
    return n
