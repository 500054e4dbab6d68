"""Fused drain pipeline: stage -> hash -> leaf insert (K1) -> level-1 slab
rows, and the aggregation cascade step (port of
``repro.kernels.pipeline``).

Transfer contract (the reference's): per drain, the raw drained spans
cross host-to-device once — src/dst/weight-bits/timestamp packed as one
``(4, nl, pad)`` int32 block plus the per-leaf lengths, staged in a
reusable pinned host buffer and copied with one ``non_blocking`` copy —
and only the per-item spill mask comes back.  Hashing, fingerprints and
LCG chains run on the device; K1 writes the finished leaves straight
into the level-1 pool's slab rows ``n0 ... n0 + nl``.  Spilled items'
hashes are recomputed on the host from the staged raw items (bit-exact
by construction).

The staging buffer is reused without double buffering: the spill-mask
read at the end of every drain waits for the stream, which orders it
after the upload, so the host never overwrites a block still in flight.

Aggregation (paper Alg. 2, the reference's ``_aggregate_step``) stays
plain torch ops on the device, as it is jnp (not Pallas) in the
reference.  It is deterministic: phase-A weight merges are an ordered
segmented sum in the reference's index order
(``cmatrix._ordered_index_add``), never an atomic scatter.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cmatrix, hashing
from repro_torch.core.params import HiggsParams
from repro_torch.kernels import leaf_insert as _li


class DrainPipeline:
    """Staging buffer + device steps for one sketch.  ``kernels=False``
    runs the plain torch version of K1 on the same device (the on-card
    check of the kernels against their plain versions)."""

    def __init__(self, params: HiggsParams, device, kernels: bool = True):
        self.params = params
        self.device = torch.device(device)
        self._insert = (_li.leaf_insert_batched if kernels
                        else _li.leaf_insert_batched_plain)
        self._host: torch.Tensor | None = None       # pinned staging

    def _staging(self, size: int) -> torch.Tensor:
        if self._host is None or self._host.numel() < size:
            cap = cmatrix.pow2_pad(size, lo=1 << 16)
            self._host = torch.empty(
                (cap,), dtype=torch.int32,
                pin_memory=self.device.type == "cuda")
        return self._host[:size]

    def ingest(self, pool, buf: np.ndarray, spans):
        """Stage the drained spans and run one fused append.

        Returns ``(base_slot, spill_mask (nl, pad) bool, stage)`` where
        ``stage`` is the ``(4, nl, pad)`` uint32 raw staging block (for
        host-side spill hash recovery) and ``base_slot`` the pool slot of
        leaf 0.
        """
        p = self.params
        r = p.r if p.use_mmb else 1
        nl = len(spans)
        pad = max(e - s for s, e in spans)
        flat = self._staging(4 * nl * pad + nl)
        host = flat.numpy().view(np.uint32)
        stage = host[: 4 * nl * pad].reshape(4, nl, pad)
        lengths = host[4 * nl * pad:]
        for i, (s, e) in enumerate(spans):
            stage[:, i, :e - s] = buf[:, s:e]
            lengths[i] = e - s
        dev = flat.to(self.device, non_blocking=True)
        items = dev[: 4 * nl * pad].view(4, nl, pad)
        valid = (torch.arange(pad, device=self.device)[None, :]
                 < dev[4 * nl * pad:, None])
        hs = hashing.mix32(items[0], p.seed)
        hd = hashing.mix32(items[1], p.seed ^ 0x5BD1E995)
        fs = hashing.fingerprint(hs, p.F1).to(torch.int32)
        fd = hashing.fingerprint(hd, p.F1).to(torch.int32)
        rows = cmatrix.chain_from_base(hashing.address(hs, p.F1, p.d1), r,
                                       p.d1).to(torch.int32)
        cols = cmatrix.chain_from_base(hashing.address(hd, p.F1, p.d1), r,
                                       p.d1).to(torch.int32)
        wf = items[2].view(torch.float32)
        pool.reserve(pool.n + nl)
        _, spill = self._insert(pool.rows(pool.n, nl), fs, fd, rows, cols,
                                wf, items[3], valid, r=r)
        # the only device-to-host copy of the drain
        spill_mask = (spill.to(torch.bool) & valid).cpu().numpy()
        base_slot = pool.adopt_slabs(pool.slabs, nl)
        return base_slot, spill_mask, stage

    def aggregate(self, child_pool, parent_pool, level: int, u0: int, m: int,
                  ob):
        """Build ``m`` ready parents at ``level`` from the child pool's
        slab rows into the parent pool's next ``m`` rows.

        ``ob`` is the host-stacked overflow-column dict of
        ``HiggsSketch._gather_child_obs_stacked`` (or ``None``), uploaded
        as one packed ``(6, m, ob_pad)`` tensor.  Returns ``(spill_mask
        (m, N) bool, spilled)`` where ``spilled`` holds the spilled items'
        canonical columns ``f1s, f1d, bs, bd, w`` in row-major (parent,
        item) order, copied to the host only when the mask is non-empty.
        """
        p = self.params
        theta = p.theta
        d, b = child_pool.d, child_pool.b
        per = theta * d * d * b
        parent_pool.reserve(parent_pool.n + m)
        ch = child_pool.rows(u0 * theta - child_pool.base, m * theta)
        e_fs = ch.fp_s.reshape(m, per)
        e_idx = ch.idx.reshape(m, per)
        grid = torch.arange(d, device=self.device, dtype=torch.int64)
        shape5 = (m, theta, d, d, b)
        e_row = grid[None, None, :, None, None].expand(shape5).reshape(m, per)
        e_col = grid[None, None, None, :, None].expand(shape5).reshape(m, per)
        e_valid = e_fs != cmatrix.EMPTY
        f1s, base_s = cmatrix.recover_leaf_coords(e_row, e_fs, e_idx, level,
                                                  p, "s")
        f1d, base_d = cmatrix.recover_leaf_coords(
            e_col, ch.fp_d.reshape(m, per), e_idx, level, p, "d")
        w_all = ch.w.reshape(m, per)
        if ob is not None:
            obp = ob["w"].shape[1]
            pack = np.zeros((6, m, obp), np.uint32)
            for row, k in enumerate(("f1s", "f1d", "bs", "bd")):
                pack[row] = ob[k]
            pack[4] = ob["w"].view(np.uint32)
            pack[5] = ob["valid"]
            pk = torch.from_numpy(pack.view(np.int32)).to(self.device)
            f1s = torch.cat([f1s, hashing.as_u32(pk[0])], 1)
            f1d = torch.cat([f1d, hashing.as_u32(pk[1])], 1)
            base_s = torch.cat([base_s, hashing.as_u32(pk[2])], 1)
            base_d = torch.cat([base_d, hashing.as_u32(pk[3])], 1)
            w_all = torch.cat([w_all, pk[4].view(torch.float32)], 1)
            e_valid = torch.cat([e_valid, pk[5] != 0], 1)
        plevel = level + 1
        fp_s_p, rows_p = cmatrix.coords_at_level(f1s, base_s, plevel, p)
        fp_d_p, cols_p = cmatrix.coords_at_level(f1d, base_d, plevel, p)
        # EMPTY entries recover garbage coordinates; zero them like the
        # reference so placement ranks agree bit for bit
        rows_p = torch.where(e_valid[..., None], rows_p, 0)
        cols_p = torch.where(e_valid[..., None], cols_p, 0)
        spill = cmatrix.aggregate_children_pre(
            parent_pool.rows(parent_pool.n, m), fp_s_p, fp_d_p, rows_p,
            cols_p, w_all, e_valid, params=p)
        parent_pool.adopt_slabs(parent_pool.slabs, m)
        spill_h = spill.cpu().numpy()
        if not spill_h.any():
            return spill_h, None
        cols = (f1s[spill], f1d[spill], base_s[spill], base_d[spill])
        spilled = {k: c.cpu().numpy().astype(np.uint32)
                   for k, c in zip(("f1s", "f1d", "bs", "bd"), cols)}
        spilled["w"] = w_all[spill].cpu().numpy().astype(np.float64)
        return spill_h, spilled
