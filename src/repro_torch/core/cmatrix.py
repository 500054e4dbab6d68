"""Compressed-matrix operations: coordinate math, the aggregation
placement engine (paper Alg. 2) and the plain probe references.

Port of ``repro.core.cmatrix``.  A node's matrix is the SoA
:class:`NodeState` of ``(..., d, d, b)`` tensors.  The reference stores
``fp_s``/``fp_d``/``t``/``idx`` as ``uint32``; torch lacks ``uint32``
arithmetic on the CPU, so the port stores them as ``int32`` bit patterns
(``EMPTY`` = ``-1`` = ``0xFFFFFFFF``) and widens to ``int64`` (masked to
32 bits, see :mod:`repro_torch.core.hashing`) wherever it computes on
them.  ``w`` is ``float32`` as in the reference.  Viewing a slab as
``np.uint32`` gives the reference's bits.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.hashing import MASK32, as_u32
from repro_torch.core.params import HiggsParams

EMPTY = -1                        # int32 bit pattern of 0xFFFFFFFF
EMPTY_U32 = np.uint32(0xFFFFFFFF)
_A = 5   # LCG multiplier (a % 4 == 1 -> full period mod 2^k)
_C = 1   # LCG increment (odd)


def pow2_pad(n: int, lo: int = 8) -> int:
    """Next power of two >= n (floor lo)."""
    return max(lo, 1 << max(0, (n - 1).bit_length()))


def lcg_tables(r: int, d: int):
    """Closed-form LCG coefficients: x_k = A_k * x_0 + B_k (mod d)."""
    A, B = [], []
    a_k, b_k = 1, 0
    for _ in range(r):
        A.append(a_k % d)
        B.append(b_k % d)
        a_k, b_k = a_k * _A, b_k * _A + _C
    inv = [pow(a % d, -1, d) if d > 1 else 0 for a in A]
    return (np.asarray(A, np.int64), np.asarray(B, np.int64),
            np.asarray(inv, np.int64))


def chain_from_base(x0: torch.Tensor, r: int, d: int) -> torch.Tensor:
    """All r chain positions from base address x0; shape (..., r)."""
    A, B, _ = lcg_tables(r, d)
    A = torch.as_tensor(A, device=x0.device)
    B = torch.as_tensor(B, device=x0.device)
    return ((x0.to(torch.int64)[..., None] * A + B) & MASK32) % d


def chain_base_from_pos(x_k: torch.Tensor, k: torch.Tensor, r: int,
                        d: int) -> torch.Tensor:
    """Recover x0 from the value at (data-dependent) chain index k."""
    _, B, Ainv = lcg_tables(r, d)
    a_inv = torch.as_tensor(Ainv, device=x_k.device)[k]
    b_k = torch.as_tensor(B, device=x_k.device)[k]
    # uint32 wraparound of the reference: d divides 2**32, so reducing
    # the exact (possibly negative) product mod d gives the same value
    return (a_inv * (x_k - b_k)) % d


class NodeState(NamedTuple):
    """One or more compressed matrices.  ``t`` is all-zeros for non-leaf
    nodes.  Integer fields are ``int32`` bit patterns of the reference's
    ``uint32``."""
    fp_s: torch.Tensor  # (..., d, d, b) int32
    fp_d: torch.Tensor  # (..., d, d, b) int32
    w: torch.Tensor     # (..., d, d, b) float32
    t: torch.Tensor     # (..., d, d, b) int32
    idx: torch.Tensor   # (..., d, d, b) int32 — MMB chain index pair i*r+j


def make_nodes(n: int, d: int, b: int, device) -> NodeState:
    """``n`` fresh matrices stacked on axis 0 (EMPTY fingerprints, zero
    weights, times and chain indices)."""
    shape = (n, d, d, b)
    return NodeState(
        fp_s=torch.full(shape, EMPTY, dtype=torch.int32, device=device),
        fp_d=torch.full(shape, EMPTY, dtype=torch.int32, device=device),
        w=torch.zeros(shape, dtype=torch.float32, device=device),
        t=torch.zeros(shape, dtype=torch.int32, device=device),
        idx=torch.zeros(shape, dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# coordinates (paper Alg. 2, closed-form chain recovery)
# ---------------------------------------------------------------------------

def recover_leaf_coords(addr: torch.Tensor, fp: torch.Tensor,
                        idx_pair: torch.Tensor, level: int,
                        params: HiggsParams, side: str):
    """From a stored entry at `level`, recover (leaf fp F1 bits, leaf base
    address), for one side ('s' -> chain index i, 'd' -> j).  Inputs are
    any integer tensors holding unsigned values; outputs are ``int64``."""
    r = params.r if params.use_mmb else 1
    R, F1, d1 = params.R, params.F1, params.d1
    s = R * (level - 1)
    addr, fp, idx_pair = as_u32(addr), as_u32(fp), as_u32(idx_pair)
    k = (idx_pair // r) if side == "s" else (idx_pair % r)
    leaf_pos = addr >> s
    fbits = addr & ((1 << s) - 1)
    f1 = (((fbits << (F1 - s)) | fp) & MASK32) if s else fp
    base = chain_base_from_pos(leaf_pos, k, r, d1)
    return f1, base


def coords_at_level(f1: torch.Tensor, base: torch.Tensor, level: int,
                    params: HiggsParams):
    """(fp_l, rows_l (..., r)) probe/placement coordinates at a tree
    level, derived by shifting the leaf-level chain."""
    r = params.r if params.use_mmb else 1
    return level_coords(f1, chain_from_base(as_u32(base), r, params.d1),
                        level, params)


def level_coords(f1: torch.Tensor, rows1: torch.Tensor, level: int,
                 params: HiggsParams):
    """(fp_l, rows_l) at a tree level from the leaf fingerprint ``f1``
    and its leaf-level chain ``rows1`` (..., r): the top ``s`` fingerprint
    bits shift into the address (the edge-probe kernel derives them the
    same way on uint32)."""
    s = params.R * (level - 1)
    F1 = params.F1
    f1, rows1 = as_u32(f1), as_u32(rows1)
    fp_l = f1 & ((1 << (F1 - s)) - 1)
    if s == 0:
        return fp_l, rows1
    top = f1 >> (F1 - s)
    rows_l = ((rows1 << s) | top[..., None]) & MASK32
    return fp_l, rows_l


def round_orders(rows: torch.Tensor, cols: torch.Tensor,
                 r: int) -> torch.Tensor:
    """(..., r*r, n) stable argsort of every round's bucket ids.

    The reference's device twin sorts twice (by column, then by row) to
    stay inside uint32; with ``int64`` one stable sort of the key
    ``row << 32 | col`` gives the same permutation as
    ``host_round_orders``'s ``row * d + col``.
    """
    i_idx = torch.as_tensor(np.repeat(np.arange(r), r), device=rows.device)
    j_idx = torch.as_tensor(np.tile(np.arange(r), r), device=rows.device)
    rk = as_u32(rows)[..., i_idx].transpose(-1, -2)
    ck = as_u32(cols)[..., j_idx].transpose(-1, -2)
    key = (rk << 32) | ck
    return torch.sort(key, dim=-1, stable=True).indices


# ---------------------------------------------------------------------------
# placement: the (merge, claim) multi-round engine behind aggregation
# ---------------------------------------------------------------------------

def _ordered_index_add(flat: torch.Tensor, tgt: torch.Tensor,
                       val: torch.Tensor) -> None:
    """``flat[tgt[i]] += val[i]`` for ascending ``i``, each addition
    rounded in turn: the reference's scatter-add order (``np.add.at``
    on the host twin).

    An unordered scatter (atomics, ``index_add_`` on a GPU) may sum
    duplicates in any order and break bit-identity.  Instead, updates
    are ranked within their target by a stable sort, and pass ``j``
    applies every rank-``j`` update at once; no target repeats inside a
    pass, so each pass is a plain gather-add-scatter, and the passes run
    in rank order.  Passes = the largest number of updates one target
    receives (small in practice: see ``place_entries_pre``).
    """
    if tgt.numel() == 0:
        return
    st, order = torch.sort(tgt, stable=True)
    sv = val[order]
    pos = torch.arange(st.numel(), device=st.device)
    first = torch.ones_like(st, dtype=torch.bool)
    first[1:] = st[1:] != st[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    for j in range(int(rank.max()) + 1):
        sel = rank == j
        ts = st[sel]
        flat[ts] = flat[ts] + sv[sel]


def place_entries_pre(nodes: NodeState, fs, fd, rows, cols, w, t, valid,
                      *, r: int, match_time: bool) -> torch.Tensor:
    """Place ``n`` items into each of ``M`` matrices, in place.

    Port of the reference's sort-free ``place_entries_pre`` batched over
    a leading axis.  nodes: ``(M, d, d, b)`` contiguous; fs/fd/t/w/valid:
    ``(M, n)``; rows/cols: ``(M, n, r)`` candidate addresses at this
    level.  Round ``k = i*r + j`` visits bucket ``(rows[:, i],
    cols[:, j])``: phase A merges an active item into the first slot
    matching ``(fp_s, fp_d[, t])``; phase B lets the remaining actives
    claim free slots, the rank of an item within its bucket being the
    number of earlier active items of the same bucket (the stable round
    order of :func:`round_orders`).  Returns ``placed & valid``.

    Phase A's weight sums follow the reference's index order
    (:func:`_ordered_index_add`).  Phase B targets are distinct, and a
    claimed slot's weight is ``0.0 + w``, as in the reference.
    """
    M, n = fs.shape
    d, b = nodes.fp_s.shape[1], nodes.fp_s.shape[3]
    dev = fs.device
    F_s, F_d = nodes.fp_s.view(-1), nodes.fp_d.view(-1)
    W, T, I = nodes.w.view(-1), nodes.t.view(-1), nodes.idx.view(-1)
    fs32, fd32 = fs.to(torch.int32), fd.to(torch.int32)
    t32 = t.to(torch.int32)
    w = w.to(torch.float32)
    pbase = (torch.arange(M, device=dev, dtype=torch.int64) * d)[:, None]
    slot_ar = torch.arange(b, device=dev, dtype=torch.int64)
    placed = ~valid
    for k in range(r * r):
        if not bool((~placed).any()):
            break            # the reference's while-loop exit: no-op rounds
        i, j = divmod(k, r)
        row = rows[..., i].to(torch.int64)
        col = cols[..., j].to(torch.int64)
        gb = (pbase + row) * d + col                         # (M, n)
        active = ~placed

        # --- phase A: merge into an existing matching entry -------------
        slots = gb[..., None] * b + slot_ar                  # (M, n, b)
        e_fs = F_s[slots]
        match = (e_fs == fs32[..., None]) & (F_d[slots] == fd32[..., None]) \
            & (e_fs != EMPTY)
        if match_time:
            match &= T[slots] == t32[..., None]
        has_match = match.any(-1) & active
        first = torch.where(match, slot_ar, b).amin(-1)
        _ordered_index_add(W, (gb * b + first)[has_match], w[has_match])
        placed = placed | has_match
        active = ~placed

        # --- phase B: claim free slots, arrival order within a bucket ---
        bid = row * d + col
        order = round_orders(rows[..., i:i + 1], cols[..., j:j + 1], 1)[:, 0]
        sb = torch.gather(bid, 1, order)
        act_s = torch.gather(active, 1, order).to(torch.int64)
        excl = torch.cumsum(act_s, 1) - act_s
        is_first = torch.ones_like(sb, dtype=torch.bool)
        is_first[:, 1:] = sb[:, 1:] != sb[:, :-1]
        seg_base = torch.cummax(torch.where(is_first, excl, 0), 1).values
        rank = torch.empty_like(excl).scatter_(1, order, excl - seg_base)
        emp_all = (nodes.fp_s == EMPTY).view(M, d * d, b)
        free_cnt = emp_all.sum(-1)
        accept = active & (rank < torch.gather(free_cnt, 1, bid))
        if bool(accept.any()):
            a_gb, a_rank = gb[accept], rank[accept]
            emp = emp_all.view(-1, b)[a_gb]                  # (A, b)
            emp_before = torch.cumsum(emp, -1) - emp.to(torch.int64)
            hit = emp & (emp_before == a_rank[:, None])
            tgt = a_gb * b + torch.where(hit, slot_ar, b).amin(-1)
            F_s[tgt] = fs32[accept]
            F_d[tgt] = fd32[accept]
            T[tgt] = t32[accept]
            I[tgt] = k
            W[tgt] = W[tgt] + w[accept]
        placed = placed | accept
    return placed & valid


def aggregate_children_pre(parents: NodeState, fp_s_p, fp_d_p, rows_p,
                           cols_p, w, valid, *, params: HiggsParams
                           ) -> torch.Tensor:
    """Build ``M`` parents from their recovered parent-level coordinates
    (entries + overflow items, ``(M, N)``) into the fresh matrices
    ``parents`` (``(M, dp, dp, b)``, updated in place).  Returns the
    spill mask ``(M, N)``."""
    r = params.r if params.use_mmb else 1
    t0 = torch.zeros_like(fp_s_p, dtype=torch.int32)
    placed = place_entries_pre(parents, fp_s_p, fp_d_p, rows_p, cols_p, w,
                               t0, valid, r=r, match_time=False)
    return valid & ~placed


# ---------------------------------------------------------------------------
# probes (query primitives) — the plain references of the probe kernels
# ---------------------------------------------------------------------------

def _in_range(t: torch.Tensor, ts: int, te: int) -> torch.Tensor:
    """Unsigned ``ts <= t <= te`` on int32 bit patterns."""
    tu = as_u32(t)
    return (tu >= (ts & MASK32)) & (tu <= (te & MASK32))


def probe_edge(nodes: NodeState, node_mask, fs, fd, rows, cols, ts: int,
               te: int, *, match_time: bool) -> torch.Tensor:
    """Sum of matching entry weights for a batch of edge queries over a
    batch of matrices.

    nodes: stacked NodeState ``(m, d, d, b)``; node_mask: ``(m,)`` bool;
    fs/fd: ``(q,)``; rows/cols: ``(q, r)``; ts/te: unsigned scalars.
    Returns ``(q,)`` float32.

    Contract: each query's candidate row/col lists are duplicate-free
    (full-period LCG chains for r <= d); a duplicated candidate would be
    counted twice here, while the reference's Pallas one-hot probe
    counts it once.
    """
    ri = rows.to(torch.int64)[:, :, None]
    ci = cols.to(torch.int64)[:, None, :]
    # (m, q, r, r, b) gathered buckets
    efs = nodes.fp_s[:, ri, ci, :]
    efd = nodes.fp_d[:, ri, ci, :]
    ew = nodes.w[:, ri, ci, :]
    # EMPTY (0xFFFFFFFF) never equals an F-bit fingerprint
    match = (efs == fs.to(torch.int32)[None, :, None, None, None]) & \
        (efd == fd.to(torch.int32)[None, :, None, None, None])
    if match_time:
        match &= _in_range(nodes.t[:, ri, ci, :], ts, te)
    match &= node_mask.to(torch.bool)[:, None, None, None, None]
    return torch.where(match, ew, 0.0).sum(dim=(0, 2, 3, 4))


def probe_vertex(nodes: NodeState, node_mask, fv, rows, ts: int, te: int,
                 *, direction: str, match_time: bool,
                 q_chunk: int = 256) -> torch.Tensor:
    """Vertex query: sum weights over r candidate rows (direction "out",
    all d columns) or columns (direction "in", all d rows) across m
    matrices.  fv: ``(q,)``, rows: ``(q, r)``.  Returns ``(q,)`` float32.

    Queries run in chunks of ``q_chunk``: one query gathers ``m*r*d*b``
    entries, which at the top levels of a large stream is too much to
    gather for every query at once.
    """
    q = fv.shape[0]
    out = torch.zeros((q,), dtype=torch.float32, device=fv.device)
    nmask = node_mask.to(torch.bool)[:, None, None, None, None]
    fp = nodes.fp_s if direction == "out" else nodes.fp_d
    for q0 in range(0, q, q_chunk):
        ri = rows[q0:q0 + q_chunk].to(torch.int64)
        if direction == "out":
            efp, ew, et = (x[:, ri] for x in (fp, nodes.w, nodes.t))
        else:                                  # (m, d, qc, r, b) -> rows last
            efp, ew, et = (x[:, :, ri].permute(0, 2, 3, 1, 4)
                           for x in (fp, nodes.w, nodes.t))
        match = efp == fv[q0:q0 + q_chunk].to(torch.int32)[
            None, :, None, None, None]
        if match_time:
            match &= _in_range(et, ts, te)
        match &= nmask
        out[q0:q0 + q_chunk] = torch.where(match, ew, 0.0).sum(
            dim=(0, 2, 3, 4))
    return out
