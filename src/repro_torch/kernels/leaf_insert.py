"""K1/K2: Algorithm-1 leaf insertion (port of ``repro.kernels.leaf_insert``).

``leaf_insert_batched`` (K1, grid over L leaves) and ``leaf_insert`` (K2,
one leaf) launch the CUDA kernel of ``csrc/leaf_insert.cu`` on CUDA
tensors and run the plain torch version on CPU tensors; any other device
raises.  Both update the matrices **in place** (the reference aliases
them input-to-output) and return ``(nodes, spill)`` with an ``int32``
spill mask.  Each kernel launch adds one to the wrapper's ``launches``.

Semantics (paper Alg. 1, the reference's ``_kernel_batched``): items of a
leaf are placed in arrival order; item e visits buckets
``(rows[e, i], cols[e, j])`` for ``k = i*r + j`` in order, and the first
bucket with a slot matching ``(fp_s, fp_d, t)`` (weight added) or, without
a match, an EMPTY slot (claimed, ``idx = k``) takes it; an item no bucket
takes is spilled.  The new weight of a slot is ``w_slot + w``.

A leaf whose matrices do not fit the device's shared memory per block
(``d*d*b*20`` bytes above the opt-in limit, about 227 KB on an H100) takes
the kernel's global-memory form, which walks the slab rows in place; such
launches also add one to the wrapper's ``global_launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.cmatrix import EMPTY, NodeState
from repro_torch.kernels import _build


def leaf_insert_batched_plain(nodes: NodeState, fs, fd, rows, cols, w, t,
                              valid, *, r: int):
    """Plain torch Alg. 1: a Python loop over items, vectorised across the
    L leaves and the r*r buckets of an item (an item writes at most once,
    so all its buckets are tested against the same state; the lowest
    bucket offering a match or a free slot wins).  nodes: ``(L, d, d,
    b)`` contiguous; fs/fd/w/t/valid: ``(L, n)``; rows/cols: ``(L, n,
    r)``."""
    L, n = fs.shape
    d, b = nodes.fp_s.shape[1], nodes.fp_s.shape[3]
    dev = fs.device
    F_s, F_d = nodes.fp_s.view(-1), nodes.fp_d.view(-1)
    W, T, I = nodes.w.view(-1), nodes.t.view(-1), nodes.idx.view(-1)
    fs, fd, t = fs.to(torch.int32), fd.to(torch.int32), t.to(torch.int32)
    w = w.to(torch.float32)
    valid = valid.to(torch.bool)
    ks = torch.arange(r * r, device=dev)
    # (L, n, r*r) bucket ids of every item, lex order k = i*r + j
    bucket = (torch.arange(L, device=dev)[:, None, None] * d
              + rows.to(torch.int64)[:, :, ks // r]) * d \
        + cols.to(torch.int64)[:, :, ks % r]
    slot_ar = torch.arange(b, device=dev)
    big = r * r * b
    spill = torch.zeros((L, n), dtype=torch.int32, device=dev)
    for e in range(n):
        live = valid[:, e]
        if not bool(live.any()):
            continue
        slots = bucket[:, e, :, None] * b + slot_ar              # (L, rr, b)
        bfs = F_s[slots]
        match = (bfs == fs[:, e, None, None]) \
            & (F_d[slots] == fd[:, e, None, None]) \
            & (T[slots] == t[:, e, None, None]) & (bfs != EMPTY)
        empty = bfs == EMPTY
        # per bucket: first matching slot, else first empty slot
        pick = torch.where(match.any(-1, keepdim=True), match, empty)
        flat = torch.where(pick, ks[:, None] * b + slot_ar, big).view(L, -1)
        first = flat.amin(-1)                                  # (L,)
        ok = live & (first < big)
        k = first // b
        cell = torch.gather(slots.view(L, -1), 1,
                            first.clamp(max=big - 1)[:, None])[:, 0]
        ins = ok & ~torch.gather(match.view(L, -1), 1,
                                 first.clamp(max=big - 1)[:, None])[:, 0]
        cw = cell[ok]
        W[cw] = W[cw] + w[ok, e]
        ci = cell[ins]
        F_s[ci] = fs[ins, e]
        F_d[ci] = fd[ins, e]
        T[ci] = t[ins, e]
        I[ci] = k[ins].to(torch.int32)
        spill[:, e] = (live & ~ok).to(torch.int32)
    return nodes, spill


def _check(nodes: NodeState, fs, fd, rows, cols, w, t, valid, r: int):
    L, n = fs.shape
    d, b = nodes.fp_s.shape[1], nodes.fp_s.shape[3]
    want = {
        "fp_s": ((L, d, d, b), torch.int32), "fp_d": ((L, d, d, b),
                                                      torch.int32),
        "w_m": ((L, d, d, b), torch.float32), "t_m": ((L, d, d, b),
                                                     torch.int32),
        "idx_m": ((L, d, d, b), torch.int32),
        "fs": ((L, n), torch.int32), "fd": ((L, n), torch.int32),
        "w": ((L, n), torch.float32), "t": ((L, n), torch.int32),
        "valid": ((L, n), torch.bool), "rows": ((L, n, r), torch.int32),
        "cols": ((L, n, r), torch.int32),
    }
    got = dict(zip(want, (*nodes, fs, fd, w, t, valid, rows, cols)))
    for name, (shape, dtype) in want.items():
        x = got[name]
        if x.device.type != "cuda" or x.device != fs.device:
            raise ValueError(f"{name}: expected a tensor on {fs.device}, "
                             f"got {x.device}")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(nodes: NodeState, fs, fd, rows, cols, w, t, valid, r: int):
    _check(nodes, fs, fd, rows, cols, w, t, valid, r)
    L, n = fs.shape
    d, b = nodes.fp_s.shape[1], nodes.fp_s.shape[3]
    spill = torch.empty((L, n), dtype=torch.int32, device=fs.device)
    lib = _build.library("leaf_insert")
    form = ctypes.c_int(-1)
    with torch.cuda.device(fs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.higgs_leaf_insert(
            *(x.data_ptr() for x in (*nodes, fs, fd, w, t, valid, rows,
                                     cols, spill)),
            L, n, d, b, r, stream, ctypes.byref(form))
    _build.check(rc, "leaf_insert")
    return spill, form.value == GLOBAL_FORM


GLOBAL_FORM = 2          # the launcher's code for the global-memory kernel


def _cuda_or_cpu(x: torch.Tensor) -> bool:
    """True for CUDA, False for CPU; any other device raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def leaf_insert_batched(nodes: NodeState, fs, fd, rows, cols, w, t, valid,
                        *, r: int):
    """K1: Alg. 1 over L stacked leaves in one launch (in place).
    Returns ``(nodes, spill (L, n) int32)``."""
    if not _cuda_or_cpu(fs):
        return leaf_insert_batched_plain(nodes, fs, fd, rows, cols, w, t,
                                         valid, r=r)
    if fs.shape[0] == 0:
        return nodes, torch.zeros(fs.shape, dtype=torch.int32,
                                  device=fs.device)
    spill, in_global = _launch(nodes, fs, fd, rows, cols, w, t, valid, r)
    leaf_insert_batched.launches += 1
    leaf_insert_batched.global_launches += in_global
    return nodes, spill


leaf_insert_batched.launches = 0
leaf_insert_batched.global_launches = 0


def leaf_insert_plain(node: NodeState, fs, fd, rows, cols, w, t, valid, *,
                      r: int):
    """Plain torch K2: the L = 1 case of :func:`leaf_insert_batched_plain`."""
    nodes = NodeState(*(x[None] for x in node))
    _, spill = leaf_insert_batched_plain(
        nodes, fs[None], fd[None], rows[None], cols[None], w[None], t[None],
        valid[None], r=r)
    return node, spill[0]


def leaf_insert(node: NodeState, fs, fd, rows, cols, w, t, valid, *,
                r: int):
    """K2: Alg. 1 for one leaf (node ``(d, d, b)``, items ``(n,)``), the
    L = 1 launch of the K1 kernel (in place).  Returns
    ``(node, spill (n,) int32)``."""
    if not _cuda_or_cpu(fs):
        return leaf_insert_plain(node, fs, fd, rows, cols, w, t, valid, r=r)
    spill, in_global = _launch(NodeState(*(x[None] for x in node)),
                               fs[None], fd[None], rows[None], cols[None],
                               w[None], t[None], valid[None], r)
    leaf_insert.launches += 1
    leaf_insert.global_launches += in_global
    return node, spill[0]


leaf_insert.launches = 0
leaf_insert.global_launches = 0
