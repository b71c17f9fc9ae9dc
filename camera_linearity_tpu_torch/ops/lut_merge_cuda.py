"""The lookup-merge experiments E6 and E7: CUDA wrappers, launch counts, the
pipeline planner, the table packers and the plain version.

Port of the Pallas functions of ``benchmarks/exp_manual_pipeline.py`` and
``benchmarks/exp_int8_planes.py``, both K1's exact-table merge on planar
stacks, each a hand-written CUDA kernel in ``csrc/exp_lut_merge.cu``:

======================  ===================================================
wrapper                 replaces (benchmarks/...)
======================  ===================================================
``merge_pipelined``     E6 ``exp_manual_pipeline.build``: the 256-entry
                        merge with the stack staged through on-chip memory
                        by a hand-written pipeline of asynchronous copies
``merge_table_form``    E7 ``exp_int8_planes.build(variant)``: the 4096-
                        entry merge with its tables as 3 bf16 parts or 4
                        byte planes (and f32, the control)
======================  ===================================================

Both take (N, C, H, W) f32 value and std stacks, the N reciprocal exposure
times ``invt`` and the two tables, and return the (C, H, W) value and std
of the merge with compat "corrected".  E6 takes (256, C) f32 tables; E7
takes 4096-entry tables as its ``form`` holds them, packed by
:func:`pack_table` (as the JAX script packs them outside its kernel).  A
wrapper checks its operands on every device: f32 stacks, contiguous, the
planar shape, 1 to ``MAX_N`` exposures, the tables' rows, type and shape.
On a CUDA tensor it then launches its kernel on the current stream and
adds one to its experiment's launch count (``KERNELS["E6"].launches`` ...),
or raises; on a CPU tensor it runs the plain version
:func:`merge_planar_plain` (E7 on the tables :func:`unpack_table` rebuilds,
as the kernel rebuilds them).  Importing this module builds nothing.

E6 streams chunks of the plane through a ring of ``stages`` slots of
shared memory; :func:`plan_pipeline` checks a (chunk, stages) setting,
picks the default and lays out the shared memory, and :func:`bulk_route`
says whether the stacks can be loaded by bulk copies (16-byte aligned
bases, a plane of a multiple of 4 elements) or take the scalar route.  E7
stages one channel's packed tables; :func:`bf16_parts` and
:func:`byte_planes` are the packers of its two forms.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .ablation_cuda import MAX_N, Experiment, Invt, _invt_values
from .hdr_cuda import _MAX_SMEM, _align, _raise_on, _stream, fused_plain_invt

Tensor = torch.Tensor

__all__ = ["merge_pipelined", "merge_table_form", "merge_planar_plain",
           "bf16_parts", "byte_planes", "pack_table", "unpack_table",
           "plan_pipeline",
           "pipeline_settings", "bulk_route", "PipePlan", "KERNELS", "FORMS",
           "CHUNKS", "STAGES", "ROWS"]

FORMS = ("f32", "bf16x3", "u8x4")  # the C enum's order
# E7's packed tables: planes of a table and their type
PLANES = {"f32": 1, "bf16x3": 3, "u8x4": 4}
DTYPES = {"f32": torch.float32, "bf16x3": torch.bfloat16, "u8x4": torch.uint8}
CHUNKS = (512, 1024, 2048)  # E6's sweep: plane elements a slot holds
STAGES = (2, 3, 4)          # and slots in the ring
ROWS = {"E6": 256, "E7": 4096}  # table rows each experiment takes

KERNELS = {
    "E6": Experiment("merge_pipelined",
                     "benchmarks/exp_manual_pipeline.py:161"),
    "E7": Experiment("merge_table_form",
                     "benchmarks/exp_int8_planes.py:194"),
}


# ---------------------------------------------------------------------------
# E6's plan
# ---------------------------------------------------------------------------

class PipePlan(NamedTuple):
    """One E6 launch, in the field order of the C struct ``PipePlan`` of
    ``csrc/exp_lut_merge.cu``; offsets and sizes in bytes.  Shared memory
    holds the (f, f') table pairs of every channel, then one mbarrier a
    slot, then ``stages`` slots of ``chunk`` elements of each of the N value
    and N std planes."""
    chunk: int       # plane elements a slot holds, one of CHUNKS
    stages: int      # slots in the ring
    bulk: int        # 1: bulk copies, 0: the scalar route
    off_bar: int     # the slots' mbarriers, after the tables
    off_slots: int   # slot 0
    slot_bytes: int  # 2 N chunk 4
    smem: int        # the launch's dynamic shared memory

    @property
    def threads(self) -> int:
        return self.chunk // 4  # a quad of elements a thread


def _layout(n: int, c: int, rows: int, chunk: int, stages: int) -> PipePlan:
    off_bar = _align(rows * c * 8)
    off_slots = _align(off_bar + 8 * stages)
    slot_bytes = 2 * n * chunk * 4
    return PipePlan(chunk, stages, 0, off_bar, off_slots, slot_bytes,
                    off_slots + stages * slot_bytes)


def plan_pipeline(n: int, c: int, chunk: Optional[int] = None,
                  stages: Optional[int] = None,
                  rows: int = ROWS["E6"]) -> PipePlan:
    """The shared-memory layout of an E6 launch over ``n`` exposures of
    ``c`` channels with ``rows``-entry tables.

    ``chunk`` is one of :data:`CHUNKS` and ``stages`` one of
    :data:`STAGES`; ``stages`` defaults to 2 (the JAX kernel's double
    buffer) and ``chunk`` to the largest whose ring fits a block: on the
    H100 at config 2 every 2-stage ring ran faster than every 3- or
    4-stage one, whatever the blocks an SM, and 2048 x 2 was the fastest
    in two of three runs (PERF.md).  Raises ValueError for another setting
    or one whose shared memory exceeds a block's 227 KB."""
    if stages is None:
        stages = 2
    if stages not in STAGES:
        raise ValueError(f"stages must be one of {STAGES}, got {stages}")
    if chunk is None:
        fits = [k for k in CHUNKS
                if _layout(n, c, rows, k, stages).smem <= _MAX_SMEM]
        chunk = max(fits, default=min(CHUNKS))  # fits nothing: raise below
    if chunk not in CHUNKS:
        raise ValueError(f"chunk must be one of {CHUNKS}, got {chunk}")
    plan = _layout(n, c, rows, chunk, stages)
    if plan.smem > _MAX_SMEM:
        raise ValueError(
            f"{stages} slots of {chunk} elements of {n} exposures need "
            f"{plan.smem} bytes of shared memory, a block has {_MAX_SMEM}")
    return plan


def pipeline_settings(n: int, c: int, chunks: Sequence[int] = CHUNKS,
                      stages: Sequence[int] = STAGES,
                      rows: int = ROWS["E6"]) -> List[Tuple[int, int]]:
    """The (chunk, stages) settings of ``chunks`` x ``stages`` whose ring
    fits a block: E6's sweep (a value outside :data:`CHUNKS` or
    :data:`STAGES` stays in, for :func:`plan_pipeline` to refuse)."""
    return [(k, s) for k in chunks for s in stages
            if _layout(n, c, rows, k, s).smem <= _MAX_SMEM]


def bulk_route(plane: int, *addresses: int) -> bool:
    """Whether E6 loads a stack of ``plane`` elements an exposure by bulk
    copies: they need 16-byte aligned addresses and sizes, so every base
    address (stacks and outputs) must be 16-byte aligned and the plane a
    multiple of 4 f32 elements."""
    return plane % 4 == 0 and all(a % 16 == 0 for a in addresses)


# ---------------------------------------------------------------------------
# E7's table forms
# ---------------------------------------------------------------------------

def bf16_parts(tab: Tensor) -> Tensor:
    """(3, rows, C) bf16: the parts p0, p1, p2 of an f32 table, each the
    bf16 rounding of what the earlier parts leave (exp_int8_planes.py:
    133-136).  Every residue of an f32 fits the 8 bits of a bf16, so
    p0 + p1 + p2, added in that order in f32, is the table exactly."""
    t = tab.to(torch.float32)
    p0 = t.to(torch.bfloat16)
    r1 = t - p0.to(torch.float32)
    p1 = r1.to(torch.bfloat16)
    p2 = (r1 - p1.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([p0, p1, p2])


def byte_planes(tab: Tensor) -> Tensor:
    """(4, rows, C) uint8: byte p of each f32 entry's bit pattern in plane
    p (exp_int8_planes.py:69-82 without its radix layout); the entry is
    b0 | b1 << 8 | b2 << 16 | b3 << 24."""
    u = tab.to(torch.float32).contiguous().view(torch.int32)
    return torch.stack([(u >> (8 * p)) & 0xFF for p in range(4)]).to(
        torch.uint8)


def _form(form: str) -> str:
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    return form


def pack_table(tab: Tensor, form: str) -> Tensor:
    """A (rows, C) f32 table as E7's ``form`` holds it, on ``tab``'s
    device: ``tab`` itself (``f32``), :func:`bf16_parts` (``bf16x3``) or
    :func:`byte_planes` (``u8x4``)."""
    if _form(form) == "f32":
        return tab.to(torch.float32).contiguous()
    return (bf16_parts if form == "bf16x3" else byte_planes)(tab).contiguous()


def unpack_table(packed: Tensor, form: str) -> Tensor:
    """The (rows, C) f32 table that E7's kernel rebuilds from ``packed``:
    the parts added in order in f32, or the bytes' bit pattern."""
    if _form(form) == "f32":
        return packed
    if form == "bf16x3":
        p0, p1, p2 = packed.to(torch.float32)
        return (p0 + p1) + p2
    b = packed.to(torch.int32)
    return (b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)).view(
        torch.float32)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def merge_planar_plain(val: Tensor, std: Tensor, invt: Invt, icrf: Tensor,
                       icrf_diff: Tensor) -> Tuple[Tensor, Tensor]:
    """Both kernels' function in PyTorch: K1's merge (compat "corrected",
    ``hdr_cuda.fused_plain_invt``) of (N, C, H, W) stacks with reciprocal
    exposure times ``invt``, through a channels-last view; (C, H, W)
    value and std."""
    n = val.shape[0]
    inv_t = torch.as_tensor(_invt_values(invt, n), dtype=torch.float32,
                            device=val.device)
    v, s = fused_plain_invt(val.permute(0, 2, 3, 1), std.permute(0, 2, 3, 1),
                            inv_t, icrf, icrf_diff)
    return v.permute(2, 0, 1).contiguous(), s.permute(2, 0, 1).contiguous()


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _checked(val: Tensor, std: Tensor, icrf: Tensor, icrf_diff: Tensor,
             rows: int, form: str = "f32") -> Tuple[int, int, int, int]:
    """(N, C, H, W) of checked operands, the tables packed as ``form``."""
    if val.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no lookup-merge kernel for device {val.device}")
    if val.ndim != 4:
        raise ValueError("stacks must be planar (N, C, H, W), got "
                         f"{tuple(val.shape)}")
    n, c, h, w = val.shape
    table = (rows, c) if PLANES[form] == 1 else (PLANES[form], rows, c)
    for name, t, shape, dtype in (
            ("val", val, val.shape, torch.float32),
            ("std", std, val.shape, torch.float32),
            ("icrf", icrf, table, DTYPES[form]),
            ("icrf_diff", icrf_diff, table, DTYPES[form])):
        if t.device != val.device:
            raise ValueError(f"{name} is on {t.device}, val on {val.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{n} exposures: the kernels take 1 to {MAX_N}")
    if h * w == 0:
        raise ValueError(f"empty planes: {tuple(val.shape)}")
    return n, c, h, w


def _outputs(val: Tensor, c: int, h: int, w: int) -> Tuple[Tensor, Tensor]:
    out_v = torch.empty((c, h, w), dtype=torch.float32, device=val.device)
    return out_v, torch.empty_like(out_v)


def merge_pipelined(val: Tensor, std: Tensor, invt: Invt, icrf: Tensor,
                    icrf_diff: Tensor, chunk: Optional[int] = None,
                    stages: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """E6: the 256-entry merge of planar stacks, staged through a ring of
    ``stages`` slots of ``chunk`` elements (:func:`plan_pipeline` checks
    the setting and picks the default).  ``invt`` holds the N reciprocal
    exposure times, passed to the kernel by value (a host tensor or
    sequence spares a synchronization)."""
    n, c, h, w = _checked(val, std, icrf, icrf_diff, ROWS["E6"])
    plan = plan_pipeline(n, c, chunk, stages)
    values = _invt_values(invt, n)
    if val.device.type == "cpu":
        return merge_planar_plain(val, std, values, icrf, icrf_diff)
    from .. import csrc
    out_v, out_s = _outputs(val, c, h, w)
    plan = plan._replace(bulk=int(bulk_route(
        c * h * w, *(t.data_ptr() for t in (val, std, out_v, out_s)))))
    err = csrc.library("exp_lut_merge").cl_merge_pipelined(
        val.data_ptr(), std.data_ptr(), icrf.data_ptr(), icrf_diff.data_ptr(),
        (ctypes.c_float * n)(*values), out_v.data_ptr(), out_s.data_ptr(), n,
        c, h * w, ROWS["E6"], _stream(), (ctypes.c_int * len(plan))(*plan))
    _raise_on(err, "merge_pipelined")
    KERNELS["E6"].launches += 1
    return out_v, out_s


def merge_table_form(val: Tensor, std: Tensor, invt: Invt, icrf: Tensor,
                     icrf_diff: Tensor, form: str) -> Tuple[Tensor, Tensor]:
    """E7: the 4096-entry merge of planar stacks with each block's channel
    tables staged in shared memory as ``form``: ``f32``, ``bf16x3`` (three
    bf16 parts) or ``u8x4`` (four byte planes).  ``icrf`` and
    ``icrf_diff`` come packed as ``form`` (:func:`pack_table`)."""
    n, c, h, w = _checked(val, std, icrf, icrf_diff, ROWS["E7"], _form(form))
    values = _invt_values(invt, n)
    if val.device.type == "cpu":
        return merge_planar_plain(val, std, values, unpack_table(icrf, form),
                                  unpack_table(icrf_diff, form))
    from .. import csrc
    out_v, out_s = _outputs(val, c, h, w)
    err = csrc.library("exp_lut_merge").cl_merge_table_form(
        val.data_ptr(), std.data_ptr(), icrf.data_ptr(), icrf_diff.data_ptr(),
        (ctypes.c_float * n)(*values), out_v.data_ptr(), out_s.data_ptr(), n,
        c, h * w, ROWS["E7"], FORMS.index(form), _stream())
    _raise_on(err, "merge_table_form")
    KERNELS["E7"].launches += 1
    return out_v, out_s
