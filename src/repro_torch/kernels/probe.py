"""K3/K4: edge and vertex probes (port of ``repro.kernels.probe``).

The wrappers take a level pool's full slabs (``(cap, d, d, b)`` fields
``fp_s, fp_d, w, t``), the slab rows ``idx`` ``(m,)`` of the probed
matrices and their ``mask`` ``(m,)``, so the kernel reads the resident
slabs through the row index (the reference's planner first takes those
rows into a copy, ``_edge_probe_fused``/``_vertex_probe_fused``).
Query coordinates are the level's fingerprints ``(q,)`` and candidate
rows/columns ``(q, r)``; ``ts``/``te`` are unsigned 32-bit bounds.

On CUDA tensors the wrappers launch ``csrc/probe.cu`` (and add one to
``launches``); on CPU tensors they run the plain versions, which follow
``cmatrix.probe_edge``/``probe_vertex``.  Results are ``(q,)`` float32.

Candidate lists must be duplicate-free (the reference's probe contract,
guaranteed by full-period LCG chains for r <= d): the reference's Pallas
one-hot form counts a duplicated candidate once, the gather forms here
twice.
"""
from __future__ import annotations

import torch

from repro_torch.core import cmatrix
from repro_torch.core.cmatrix import NodeState
from repro_torch.core.hashing import MASK32
from repro_torch.kernels import _build
from repro_torch.kernels.leaf_insert import _cuda_or_cpu


def _rows_of(slabs: NodeState, idx) -> NodeState:
    return NodeState(*(f[idx.to(torch.int64)] for f in slabs))


def edge_probe_plain(slabs: NodeState, idx, mask, fs, fd, rows, cols,
                     ts: int, te: int, *, match_time: bool) -> torch.Tensor:
    return cmatrix.probe_edge(_rows_of(slabs, idx), mask, fs, fd, rows,
                              cols, ts, te, match_time=match_time)


def vertex_probe_plain(slabs: NodeState, idx, mask, fv, rows, ts: int,
                       te: int, *, direction: str,
                       match_time: bool) -> torch.Tensor:
    return cmatrix.probe_vertex(_rows_of(slabs, idx), mask, fv, rows, ts,
                                te, direction=direction,
                                match_time=match_time)


def _check(dev, **tensors):
    for name, (x, dtype) in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name}: expected a tensor on {dev}, got "
                             f"{x.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _geometry(slabs: NodeState, idx, mask, rows):
    cap, d, d2, b = slabs.fp_s.shape
    if d2 != d or any(f.shape != slabs.fp_s.shape for f in slabs[:4]):
        raise ValueError("slab fields must share one (cap, d, d, b) shape")
    if idx.shape != mask.shape or idx.dim() != 1:
        raise ValueError("idx and mask must be (m,)")
    return idx.shape[0], rows.shape[0], d, b, rows.shape[1]


def edge_probe(slabs: NodeState, idx, mask, fs, fd, rows, cols, ts: int,
               te: int, *, match_time: bool) -> torch.Tensor:
    """K3: ``(q,)`` summed weights of slots in buckets ``rows[q] x
    cols[q]`` of the ``m`` matrices whose ``(fp_s, fp_d)`` equal the
    query's (and, with ``match_time``, whose ``t`` lies in
    ``[ts, te]``)."""
    if not _cuda_or_cpu(fs):
        return edge_probe_plain(slabs, idx, mask, fs, fd, rows, cols, ts,
                                te, match_time=match_time)
    m, q, d, b, r = _geometry(slabs, idx, mask, rows)
    i32 = torch.int32
    _check(fs.device, fp_s=(slabs.fp_s, i32), fp_d=(slabs.fp_d, i32),
           w=(slabs.w, torch.float32), t=(slabs.t, i32), idx=(idx, i32),
           mask=(mask, torch.bool), fs=(fs, i32), fd=(fd, i32),
           rows=(rows, i32), cols=(cols, i32))
    if fs.shape != (q,) or fd.shape != (q,) or cols.shape != (q, r):
        raise ValueError("fs/fd must be (q,) and rows/cols (q, r)")
    out = torch.empty((q,), dtype=torch.float32, device=fs.device)
    lib = _build.library("probe")
    with torch.cuda.device(fs.device):
        rc = lib.higgs_edge_probe(
            *(x.data_ptr() for x in (slabs.fp_s, slabs.fp_d, slabs.w,
                                     slabs.t, idx, mask, fs, fd, rows,
                                     cols)),
            ts & MASK32, te & MASK32, int(match_time), out.data_ptr(),
            m, q, d, b, r, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "edge_probe")
    edge_probe.launches += 1
    return out


edge_probe.launches = 0


def vertex_probe(slabs: NodeState, idx, mask, fv, rows, ts: int, te: int,
                 *, direction: str, match_time: bool) -> torch.Tensor:
    """K4: ``(q,)`` summed weights of slots whose ``fp_s`` (direction
    "out": the r candidate rows, all d columns) or ``fp_d`` ("in": all d
    rows of the r candidate columns) equals ``fv``, over the ``m``
    matrices (optional time filter)."""
    if direction not in ("out", "in"):
        raise ValueError(f"direction must be 'out'/'in', got {direction!r}")
    if not _cuda_or_cpu(fv):
        return vertex_probe_plain(slabs, idx, mask, fv, rows, ts, te,
                                  direction=direction, match_time=match_time)
    m, q, d, b, r = _geometry(slabs, idx, mask, rows)
    i32 = torch.int32
    fp = slabs.fp_s if direction == "out" else slabs.fp_d
    _check(fv.device, fp=(fp, i32), w=(slabs.w, torch.float32),
           t=(slabs.t, i32), idx=(idx, i32), mask=(mask, torch.bool),
           fv=(fv, i32), rows=(rows, i32))
    if fv.shape != (q,):
        raise ValueError("fv must be (q,) and rows (q, r)")
    if not (1 <= b <= 768 and 1 <= r <= 16384):
        raise ValueError(f"the vertex-probe kernel takes 1 <= b <= 768 and "
                         f"1 <= r <= 16384, got b={b}, r={r}")
    out = torch.empty((q,), dtype=torch.float32, device=fv.device)
    lib = _build.library("probe")
    ws = torch.empty((lib.higgs_vertex_probe_workspace(m, q, d, r),),
                     dtype=torch.int32, device=fv.device)
    with torch.cuda.device(fv.device):
        rc = lib.higgs_vertex_probe(
            *(x.data_ptr() for x in (fp, slabs.w, slabs.t, idx, mask, fv,
                                     rows)),
            ts & MASK32, te & MASK32, int(match_time),
            int(direction == "in"), out.data_ptr(), ws.data_ptr(), m, q, d,
            b, r, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "vertex_probe")
    vertex_probe.launches += 1
    return out


vertex_probe.launches = 0
