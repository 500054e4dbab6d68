"""K3/K4: edge and vertex probes (port of ``repro.kernels.probe``).

The wrappers take a level pool's full slabs (``(cap, d, d, b)`` fields
``fp_s, fp_d, w, t``), the slab rows ``idx`` ``(m,)`` of the probed
matrices and their ``mask`` ``(m,)``, so the kernel reads the resident
slabs through the row index (the reference's planner first takes those
rows into a copy, ``_edge_probe_fused``/``_vertex_probe_fused``).
Query coordinates are the level's fingerprints ``(q,)`` and candidate
rows/columns ``(q, r)``; ``ts``/``te`` are unsigned 32-bit bounds.

On CUDA tensors the wrappers launch ``csrc/probe.cu`` (and add one to
``launches`` per launch); on CPU tensors they run the plain versions,
which follow ``cmatrix.probe_edge``/``probe_vertex``.  Results are
``(q,)`` float32.

``edge_probe_levels`` is K3 as the planner calls it: one launch for all
the probe entries of an edge batch (an :class:`EdgeEntry` per (level,
range class)), with the queries given at the leaf level, and the kernel
deriving each level's coordinates; ``edge_probe`` is the same kernel for
one entry given at its level.  Both count K3's launches in
``edge_probe.launches``.

Candidate lists must be duplicate-free (the reference's probe contract,
guaranteed by full-period LCG chains for r <= d): the reference's Pallas
one-hot form counts a duplicated candidate once, the gather forms here
twice.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import cmatrix
from repro_torch.core.cmatrix import NodeState
from repro_torch.core.hashing import MASK32
from repro_torch.core.params import HiggsParams
from repro_torch.kernels import _build
from repro_torch.kernels.leaf_insert import _cuda_or_cpu

MAX_ENTRIES = 16          # K3 entries per launch (kMaxEntries in probe.cu)
VERTEX_MAX_R = 16384      # K4 candidates per query (kMaxPairs in probe.cu)


class EdgeEntry(NamedTuple):
    """One K3 probe entry: one (level, range class) of a query plan."""
    slabs: NodeState        # the level pool's full (cap, d, d, b) slabs
    idx: np.ndarray         # (m,) int32 slab rows of the probed matrices
    mask: np.ndarray        # (m,) bool: matrices taking part
    level: int
    ts: int                 # unsigned 32-bit time bounds
    te: int
    match_time: bool


class _EdgeEntry(ctypes.Structure):
    """``EdgeEntry`` of ``csrc/probe.cu`` (64 bytes)."""
    _fields_ = [("fp_s", ctypes.c_void_p), ("fp_d", ctypes.c_void_p),
                ("w", ctypes.c_void_p), ("t", ctypes.c_void_p),
                ("d", ctypes.c_int), ("m", ctypes.c_int),
                ("off", ctypes.c_int), ("s", ctypes.c_int),
                ("ts", ctypes.c_uint), ("te", ctypes.c_uint),
                ("match_time", ctypes.c_int), ("pad", ctypes.c_int)]


def _rows_of(slabs: NodeState, idx) -> NodeState:
    return NodeState(*(f[idx.to(torch.int64)] for f in slabs))


def edge_probe_plain(slabs: NodeState, idx, mask, fs, fd, rows, cols,
                     ts: int, te: int, *, match_time: bool) -> torch.Tensor:
    return cmatrix.probe_edge(_rows_of(slabs, idx), mask, fs, fd, rows,
                              cols, ts, te, match_time=match_time)


def edge_probe_levels_plain(entries, f1s, rows1, f1d, cols1, *,
                            params: HiggsParams) -> torch.Tensor:
    """Plain K3 over probe entries: ``(len(entries), q)`` float32, row k
    the probe of ``entries[k]`` at its level's coordinates."""
    outs = []
    for e in entries:
        dev = e.slabs.fp_s.device
        fs, rows = cmatrix.level_coords(f1s, rows1, e.level, params)
        fd, cols = cmatrix.level_coords(f1d, cols1, e.level, params)
        outs.append(edge_probe_plain(
            e.slabs, torch.as_tensor(e.idx, device=dev),
            torch.as_tensor(e.mask, device=dev), fs, fd, rows, cols, e.ts,
            e.te, match_time=e.match_time))
    if not outs:
        return torch.zeros((0, f1s.shape[0]), dtype=torch.float32,
                           device=f1s.device)
    return torch.stack(outs)


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


def _slab_shape(slabs: NodeState):
    cap, d, d2, b = slabs.fp_s.shape
    if d2 != d or any(f.shape != slabs.fp_s.shape for f in slabs[:4]):
        raise ValueError("slab fields must share one (cap, d, d, b) shape")
    return cap, d, b


def _geometry(slabs: NodeState, idx, mask, rows):
    _, d, b = _slab_shape(slabs)
    if idx.shape != mask.shape or idx.dim() != 1:
        raise ValueError("idx and mask must be (m,)")
    return idx.shape[0], rows.shape[0], d, b, rows.shape[1]


def _check_slabs(dev, slabs: NodeState):
    i32 = torch.int32
    _check(dev, fp_s=(slabs.fp_s, i32), fp_d=(slabs.fp_d, i32),
           w=(slabs.w, torch.float32), t=(slabs.t, i32))


def _entry(slabs: NodeState, m: int, off: int, s: int, ts: int, te: int,
           match_time: bool) -> _EdgeEntry:
    return _EdgeEntry(slabs.fp_s.data_ptr(), slabs.fp_d.data_ptr(),
                      slabs.w.data_ptr(), slabs.t.data_ptr(),
                      slabs.fp_s.shape[1], m, off, s, ts & MASK32,
                      te & MASK32, int(match_time), 0)


def _launch_edge(descs, idx_ptr: int, mask_ptr: int, f1s, rows1, f1d,
                 cols1, out, b: int, F1: int) -> None:
    """K3 over the ``descs`` entries (one launch per MAX_ENTRIES)."""
    n, (q, r) = len(descs), rows1.shape
    lib = _build.library("probe")
    with torch.cuda.device(f1s.device):
        rc = lib.higgs_edge_probe_levels(
            descs, n, idx_ptr, mask_ptr,
            *(x.data_ptr() for x in (f1s, rows1, f1d, cols1, out)), q, b, r,
            F1, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "edge_probe")
    if n and q:
        edge_probe.launches += -(-n // MAX_ENTRIES)


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
    _check_slabs(fs.device, slabs)
    _check(fs.device, idx=(idx, i32), mask=(mask, torch.bool),
           fs=(fs, i32), fd=(fd, i32), rows=(rows, i32), cols=(cols, i32))
    if fs.shape != (q,) or fd.shape != (q,) or cols.shape != (q, r):
        raise ValueError("fs/fd must be (q,) and rows/cols (q, r)")
    out = torch.empty((q,), dtype=torch.float32, device=fs.device)
    # the coordinates are at the entry's level already: shift s = 0 of a
    # 32-bit fingerprint leaves them as they are
    descs = (_EdgeEntry * 1)(_entry(slabs, m, 0, 0, ts, te, match_time))
    _launch_edge(descs, idx.data_ptr(), mask.data_ptr(), fs, rows, fd, cols,
                 out, b, 32)
    return out


edge_probe.launches = 0


def edge_probe_levels(entries, f1s, rows1, f1d, cols1, *,
                      params: HiggsParams) -> torch.Tensor:
    """K3 over the probe entries of an edge batch: ``(len(entries), q)``
    float32, row k the :func:`edge_probe` of ``entries[k]`` at its
    level's coordinates, which the kernel derives from the leaf-level
    fingerprints ``f1s``/``f1d`` ``(q,)`` and chains ``rows1``/``cols1``
    ``(q, r)`` (``cmatrix.level_coords``).  One launch (per
    ``MAX_ENTRIES`` entries); the entries' host ``idx``/``mask`` go to the
    card in one copy."""
    if not _cuda_or_cpu(f1s):
        return edge_probe_levels_plain(entries, f1s, rows1, f1d, cols1,
                                       params=params)
    dev = f1s.device
    i32 = torch.int32
    _check(dev, f1s=(f1s, i32), rows1=(rows1, i32), f1d=(f1d, i32),
           cols1=(cols1, i32))
    q = f1s.shape[0]
    if f1s.dim() != 1 or f1d.shape != (q,) or rows1.dim() != 2 \
            or rows1.shape[0] != q or cols1.shape != rows1.shape:
        raise ValueError("f1s/f1d must be (q,) and rows1/cols1 (q, r)")
    out = torch.empty((len(entries), q), dtype=torch.float32, device=dev)
    if not entries:
        return out
    descs = (_EdgeEntry * len(entries))()
    b = entries[0].slabs.fp_s.shape[3]
    idxs, masks, off = [], [], 0
    for k, e in enumerate(entries):
        _check_slabs(dev, e.slabs)
        cap, d, eb = _slab_shape(e.slabs)
        if not 1 <= e.level <= params.max_levels or d != params.d(e.level) \
                or eb != b:
            raise ValueError(f"entry {k}: level {e.level} slabs of side "
                             f"{d} and {eb} slots do not fit the params")
        idx = np.asarray(e.idx, np.int32)
        mask = np.asarray(e.mask, bool)
        if idx.shape != mask.shape or idx.ndim != 1:
            raise ValueError("idx and mask must be (m,)")
        if idx.size and not (0 <= idx.min() and idx.max() < cap):
            raise ValueError(f"entry {k}: idx outside the {cap} slab rows")
        descs[k] = _entry(e.slabs, len(idx), off, params.R * (e.level - 1),
                          e.ts, e.te, e.match_time)
        idxs.append(idx)
        masks.append(mask)
        off += len(idx)
    buf = np.concatenate([np.concatenate(idxs).view(np.uint8),
                          np.concatenate(masks).view(np.uint8)])
    # idx (int32), then mask; from pinned memory the copy joins the stream
    # without a host sync (a pageable copy would wait for the device)
    meta = torch.from_numpy(buf).pin_memory().to(dev, non_blocking=True)
    _launch_edge(descs, meta.data_ptr(), meta.data_ptr() + 4 * off, f1s,
                 rows1, f1d, cols1, out, b, params.F1)
    return out


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
    if not 1 <= r <= VERTEX_MAX_R:
        raise ValueError(f"the vertex-probe kernel takes 1 <= r <= "
                         f"{VERTEX_MAX_R}, got r={r}")
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
