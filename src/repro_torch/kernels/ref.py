"""NumPy oracle of the leaf-insert kernels (port of
``repro.kernels.ref.seq_insert_ref``).

``seq_insert_ref`` is the paper's Algorithm 1 with verbatim sequential
semantics: per item, probe the r x r mapping buckets in lex order, merge
on a ``(fp_s, fp_d, t)`` match, else claim the first empty slot, and
spill when no bucket offers either.  The K1/K2 kernels and their plain
torch versions must match it bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.cmatrix import EMPTY_U32, NodeState


def seq_insert_ref(node, fs, fd, rows, cols, w, t, valid, *, b: int,
                   r: int):
    """Sequential Alg. 1 on host numpy.  ``node`` holds ``(d, d, b)``
    fields (numpy or CPU tensors; integer fields as uint32 or their
    int32 bit patterns).  Returns (NodeState of numpy arrays with the
    reference's dtypes, spill mask)."""
    def u32(x):
        return np.array(x).view(np.uint32) if np.array(x).dtype == np.int32 \
            else np.array(x, np.uint32)

    fps, fpd = u32(node.fp_s), u32(node.fp_d)
    wm = np.array(node.w, np.float32)
    tm, idxm = u32(node.t), u32(node.idx)
    fs, fd = np.asarray(fs, np.uint32), np.asarray(fd, np.uint32)
    rows, cols = np.asarray(rows), np.asarray(cols)
    w, t = np.asarray(w, np.float32), np.asarray(t, np.uint32)
    valid = np.asarray(valid, bool)
    n = len(fs)
    spill = np.zeros(n, bool)
    for e in range(n):
        if not valid[e]:
            continue
        done = False
        for k in range(r * r):
            i, j = k // r, k % r
            row, col = int(rows[e, i]), int(cols[e, j])
            bucket_fs = fps[row, col]
            match = ((bucket_fs == fs[e]) & (fpd[row, col] == fd[e]) &
                     (tm[row, col] == t[e]) & (bucket_fs != EMPTY_U32))
            hit = np.nonzero(match)[0]
            if hit.size:
                wm[row, col, hit[0]] += w[e]
                done = True
                break
            free = np.nonzero(bucket_fs == EMPTY_U32)[0]
            if free.size:
                s = free[0]
                fps[row, col, s] = fs[e]
                fpd[row, col, s] = fd[e]
                wm[row, col, s] = w[e]
                tm[row, col, s] = t[e]
                idxm[row, col, s] = k
                done = True
                break
        if not done:
            spill[e] = True
    return NodeState(fps, fpd, wm, tm, idxm), spill
