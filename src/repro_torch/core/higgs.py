"""HIGGS: the item-based, bottom-up hierarchical graph-stream summary
(port of ``repro.core.higgs`` for PyTorch and CUDA).

Host/device split: tree metadata (leaf start/end timestamps, per-level
node counts, overflow blocks) lives on the host; the compressed matrices
live on the device as per-level pools.  Insertion is chunked — each chunk
of ``params.chunk_size`` stream items becomes one leaf, with
equal-timestamp runs never split across leaves (a run longer than a chunk
spills into the leaf's overflow block).  Aggregation (paper Alg. 2) fires
bottom-up whenever theta nodes of a level complete.

This port takes the reference's accelerator path: the Alg.-1 leaf insert
of ``insert_backend="pallas"`` with device-resident pools
(``pool_storage="device"``), which it reproduces bit for bit, retention
policies (the segment lifecycle) and snapshots included.  The other
insert engines and the read-epoch surface are not ported yet (ROADMAP.md,
module items 10-12).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.planner import QueryPlanner
from repro_torch.api.protocol import SnapshotMixin
from repro_torch.api.queries import QueryBatch, QueryResult
from repro_torch.core import hashing
from repro_torch.core.cmatrix import NodeState
from repro_torch.core.params import HiggsParams
from repro_torch.core.pool import _LevelPool
from repro_torch.core.segments import SegmentStore
from repro_torch.kernels.pipeline import DrainPipeline
from repro_torch.kernels.probe import VERTEX_MAX_R


def resolve_device(device) -> torch.device:
    """``None`` means the card; without one that raises (the CPU runs
    only when asked for)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain versions "
                               "of the kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def port_params(config: dict) -> HiggsParams:
    """The params of a saved ``config`` (a reference's or the port's) as
    the port runs them: the reference's pallas engine on device pools.
    A port's own config comes back unchanged."""
    cfg = dict(config)
    if cfg.get("insert_backend") not in ("auto", "pallas"):
        cfg["insert_backend"] = "pallas"
    if cfg.get("pool_storage") not in ("auto", "device"):
        cfg["pool_storage"] = "device"
    cfg.update(batched_ingest=True, interpret=None)
    return HiggsParams(**cfg)


class _LeafIndex:
    """Leaf [start, end] timestamp keys (the B+-tree key strip) with
    amortized-doubling storage."""

    def __init__(self):
        self.n = 0
        self._starts = np.zeros((16,), np.uint64)
        self._ends = np.zeros((16,), np.uint64)

    def _reserve(self, need: int) -> None:
        if need <= len(self._starts):
            return
        cap = len(self._starts)
        while cap < need:
            cap *= 2
        starts = np.zeros((cap,), np.uint64)
        ends = np.zeros((cap,), np.uint64)
        starts[: self.n] = self._starts[: self.n]
        ends[: self.n] = self._ends[: self.n]
        self._starts, self._ends = starts, ends

    def extend(self, ts0s: np.ndarray, ts1s: np.ndarray) -> None:
        m = len(ts0s)
        self._reserve(self.n + m)
        self._starts[self.n:self.n + m] = ts0s
        self._ends[self.n:self.n + m] = ts1s
        self.n += m

    def drop_prefix(self, k: int) -> None:
        """Drop the ``k`` oldest interval keys (evicted or coarsened
        leaves); the retained keys slide to the front in place."""
        if k <= 0:
            return
        if k > self.n:
            raise ValueError(f"cannot drop {k} of {self.n} leaf keys")
        self._starts[: self.n - k] = self._starts[k: self.n].copy()
        self._ends[: self.n - k] = self._ends[k: self.n].copy()
        self.n -= k

    def load(self, starts: np.ndarray, ends: np.ndarray) -> None:
        """Overwrite with snapshot keys (fresh doubling storage)."""
        self.n = 0
        self._starts = np.zeros((16,), np.uint64)
        self._ends = np.zeros((16,), np.uint64)
        self.extend(np.asarray(starts, np.uint64),
                    np.asarray(ends, np.uint64))

    @property
    def starts(self) -> np.ndarray:
        return self._starts[: self.n]

    @property
    def ends(self) -> np.ndarray:
        return self._ends[: self.n]


class _OverflowStore:
    """Host-side overflow blocks: canonical entries per (level, node),
    columns growing by amortized doubling."""

    FIELDS = ("f1s", "f1d", "bs", "bd", "w", "t")

    def __init__(self):
        self._cols: dict[tuple[int, int], dict[str, np.ndarray]] = {}
        self._len: dict[tuple[int, int], int] = {}

    @staticmethod
    def _dtype(field: str):
        return np.float64 if field == "w" else np.uint32

    def add(self, level: int, node: int, **cols) -> None:
        n = len(cols["w"])
        if n == 0:
            return
        key = (level, node)
        store = self._cols.get(key)
        if store is None:
            store = {k: np.zeros((max(16, n),), self._dtype(k))
                     for k in self.FIELDS}
            self._cols[key] = store
            self._len[key] = 0
        m = self._len[key]
        cap = len(store["w"])
        if m + n > cap:
            new_cap = max(2 * cap, m + n)
            for k in self.FIELDS:
                buf = np.zeros((new_cap,), self._dtype(k))
                buf[:m] = store[k][:m]
                store[k] = buf
        for k in self.FIELDS:
            store[k][m:m + n] = np.asarray(cols.get(k, np.zeros(n)),
                                           self._dtype(k))
        self._len[key] = m + n

    def get(self, level: int, node: int):
        key = (level, node)
        if key not in self._cols:
            return None
        m = self._len[key]
        return {k: v[:m] for k, v in self._cols[key].items()}

    def drop(self, level: int, node: int) -> int:
        """Discard the entries of one (level, node) key (segment eviction
        pruning); returns the number of entries freed."""
        key = (level, node)
        freed = self._len.pop(key, 0)
        self._cols.pop(key, None)
        return freed

    @property
    def data(self) -> dict:
        """Trimmed {(level, node): columns} view (accounting/tests)."""
        return {key: self.get(*key) for key in self._cols}

    def total_entries(self) -> int:
        return sum(self._len.values())

    def load(self, records: dict) -> None:
        """Overwrite with snapshot records {(level, node): columns}."""
        self._cols.clear()
        self._len.clear()
        for (level, node), cols in records.items():
            self.add(level, node, **cols)


class HiggsSketch(SnapshotMixin):
    """The HIGGS structure with its matrices on a torch device.

    ``device=None`` means CUDA and raises when no card is present; pass
    ``device="cpu"`` to run on the CPU, where every kernel wrapper takes
    its plain torch version.  ``kernels=False`` runs the plain versions
    on any device (the on-card check of the kernels).  ``save``/``restore``
    (from :class:`SnapshotMixin`) write and read the reference's snapshot
    layout, so either package restores the other's snapshots.
    """

    name = "HIGGS"
    snapshot_kind = "higgs"
    # where the sketch runs, not what it holds: a restore keeps the
    # restoring sketch's own (higgslint R3)
    _SNAPSHOT_DERIVED = ("device", "_kernels", "_pipeline", "planner")

    def __init__(self, params: HiggsParams = HiggsParams(), device=None,
                 kernels: bool = True):
        if params.insert_backend not in ("auto", "pallas") \
                or params.pool_storage not in ("auto", "device") \
                or not (params.use_ob and params.batched_ingest):
            raise NotImplementedError(
                "the port runs the reference's pallas insert engine on "
                "device pools; other engines are ROADMAP.md module item 10")
        self.params = params
        self.device = resolve_device(device)
        self._kernels = kernels
        r = params.r if params.use_mmb else 1
        if kernels and self.device.type == "cuda" and r > VERTEX_MAX_R:
            raise ValueError(
                f"r={r}: the vertex-probe kernel takes at most "
                f"{VERTEX_MAX_R} candidates per query (all of a query's "
                f"(query, candidate) pairs go through one launch)")
        self.pools: list[_LevelPool] = [
            _LevelPool(params.d1, params.b, self.device)]   # level 1
        self._leaves = _LeafIndex()
        self.ob = _OverflowStore()
        self._buf: list[np.ndarray] = []           # pending raw items
        self._buf_len = 0
        self.n_items = 0
        self.segments = SegmentStore(params)       # temporal lifecycle
        self._t_last = 0                           # newest closed-leaf end
        self._version = 0                          # bumped on tree mutation
        self._pipeline = DrainPipeline(params, self.device, kernels)
        self.planner = QueryPlanner(self, kernels)

    @property
    def leaf_starts(self) -> np.ndarray:
        return self._leaves.starts

    @property
    def leaf_ends(self) -> np.ndarray:
        return self._leaves.ends

    @property
    def structure_version(self) -> int:
        """Monotone counter of tree mutations; the planner's memoized
        boundary-search plans are valid for a single version."""
        return self._version

    def query(self, queries: QueryBatch) -> QueryResult:
        """Execute a typed query batch: one boundary search per distinct
        time range, one probe launch per (level, range class)."""
        return self.planner.execute(queries)

    # ------------------------------------------------------------------
    # persistence (the reference's snapshot layout, key for key)
    # ------------------------------------------------------------------

    def state_dict(self):
        """Full sketch state as flat host arrays + JSON-able metadata, in
        the reference's layout and dtypes (``uint32`` pool fields, the
        port's ``int32`` bit patterns reinterpreted).

        This is the port's device-to-host barrier for the pools: one copy
        per slab field, trimmed to the retained nodes.
        """
        arrays: dict[str, np.ndarray] = {
            "leaf_starts": self._leaves.starts.copy(),
            "leaf_ends": self._leaves.ends.copy(),
            "buf": (np.concatenate(self._buf, axis=1) if self._buf
                    else np.zeros((4, 0), np.uint32)),
        }
        pools_meta = []
        for lvl, pool in enumerate(self.pools, start=1):
            pools_meta.append({"n": int(pool.n), "cap": int(pool.cap),
                               "d": int(pool.d), "b": int(pool.b),
                               "base": int(pool.base)})
            for name, a in pool.export().items():
                arrays[f"pool{lvl}/{name}"] = a
        ob_keys = []
        for (level, node), cols in self.ob.data.items():
            ob_keys.append([int(level), int(node)])
            for field, col in cols.items():
                arrays[f"ob/{level}.{node}/{field}"] = col.copy()
        meta = {
            "config": dataclasses.asdict(self.params),
            "n_items": int(self.n_items),
            "buf_len": int(self._buf_len),
            "version": int(self._version),
            "probe_counter": 0,            # the port keeps no such counter
            "pools": pools_meta,
            "ob_keys": ob_keys,
            "t_last": int(self._t_last),
            "segments": self.segments.meta(),
        }
        return arrays, meta

    def load_state(self, arrays: dict, meta: dict) -> None:
        """Exact inverse of :meth:`state_dict` (and of the reference's):
        reconfigure from the saved params, as the port runs them, and
        overwrite all state.  The sketch keeps its device and its
        ``kernels`` flag; the planner's plan cache is re-seeded."""
        self.__init__(port_params(meta["config"]), device=self.device,
                      kernels=self._kernels)
        for lvl, pm in enumerate(meta["pools"], start=1):
            if lvl > len(self.pools):
                self.pools.append(_LevelPool(int(pm["d"]), int(pm["b"]),
                                             self.device))
            self.pools[lvl - 1].load(
                {name: arrays[f"pool{lvl}/{name}"]
                 for name in NodeState._fields},
                int(pm["n"]), cap=int(pm["cap"]),
                base=int(pm.get("base", 0)))
        self._leaves.load(arrays["leaf_starts"], arrays["leaf_ends"])
        self.ob.load({(int(lvl), int(node)):
                      {f: arrays[f"ob/{lvl}.{node}/{f}"]
                       for f in _OverflowStore.FIELDS}
                      for lvl, node in meta["ob_keys"]})
        buf = np.ascontiguousarray(arrays["buf"], np.uint32)
        self._buf = [buf] if buf.shape[1] else []
        self._buf_len = int(meta["buf_len"])
        self.n_items = int(meta["n_items"])
        self._t_last = int(meta.get("t_last", 0))
        self.segments.load(meta.get("segments"))
        self._version = int(meta["version"])
        self.planner.invalidate()

    # ------------------------------------------------------------------
    # insertion
    # ------------------------------------------------------------------

    def insert(self, src, dst, w, t) -> None:
        """Insert a batch of stream items (arrival order, t non-decreasing).

        src/dst: uint32 vertex ids; w: weights (negative = deletion);
        t: uint32 timestamps.
        """
        batch = np.stack([
            np.asarray(src, np.uint32), np.asarray(dst, np.uint32),
            np.asarray(w, np.float32).view(np.uint32),
            np.asarray(t, np.uint32)], axis=0)
        self._buf.append(batch)
        self._buf_len += batch.shape[1]
        self.n_items += batch.shape[1]
        self._drain(final=False)

    def flush(self) -> None:
        """Close the current partial leaf (end of stream / snapshot)."""
        self._drain(final=True)
        if self.segments.active:
            self._lifecycle()          # idempotent; a no-op drain must
            #                            still settle expired segments

    def _drain(self, final: bool) -> None:
        """Split the pending buffer into every complete leaf at once.

        Chunk boundaries are a deterministic function of the buffered item
        sequence alone (never of how ``insert`` batched it); all spans
        then close in one fused launch.
        """
        cs = self.params.chunk_size
        if self._buf_len < cs and not (final and self._buf_len > 0):
            return
        buf = np.concatenate(self._buf, axis=1) if len(self._buf) > 1 \
            else self._buf[0]
        ts_col = buf[3]
        n = buf.shape[1]
        spans: list[tuple[int, int]] = []
        pos = 0
        while n - pos >= cs or (final and n - pos > 0):
            rem = n - pos
            take = min(cs, rem)
            if take < rem and ts_col[pos + take] == ts_col[pos + take - 1]:
                # never split a run of equal timestamps across leaves
                boundary_t = ts_col[pos + take - 1]
                tail = ts_col[pos:]
                run_end = int(np.searchsorted(tail, boundary_t, "right"))
                run_start = int(np.searchsorted(tail, boundary_t, "left"))
                # a run longer than a chunk becomes an oversize leaf whose
                # excess lands in the overflow block (the paper's OB case)
                take = run_end if run_start == 0 else run_start
                if take <= 0:
                    raise ValueError(
                        "non-monotonic timestamps in the pending "
                        "buffer: stream items must arrive with "
                        "non-decreasing t")
            if not final and take == rem:
                # cannot prove the trailing timestamp run has ended — wait
                break
            spans.append((pos, pos + take))
            pos += take
        if pos:
            rest = buf[:, pos:]
            self._buf = [rest] if rest.shape[1] else []
            self._buf_len = int(rest.shape[1])
        else:
            self._buf = [buf]          # keep concatenated for the next call
        if not spans:
            return
        self._close_leaves_fused(buf, spans)
        if self.segments.active:
            self._lifecycle()

    def _close_leaves_fused(self, buf: np.ndarray,
                            spans: list[tuple[int, int]]) -> None:
        """Stage the raw spans once; hashing, K1 placement and the append
        into the level-1 slabs happen on the device.  Only the spill mask
        returns; spilled items are re-hashed here from the staged raw
        items into the overflow store."""
        p = self.params
        nl = len(spans)
        pool = self.pools[0]
        base_slot, spill_mask, stage = self._pipeline.ingest(pool, buf,
                                                             spans)
        base = pool.base + base_slot
        starts = buf[3, [s for s, _ in spans]]
        ends = buf[3, [e - 1 for _, e in spans]]
        self._leaves.extend(starts, ends)
        self._t_last = max(self._t_last, int(ends[-1]))
        self.segments.on_leaves([e - s for s, e in spans])
        self._version += nl

        if spill_mask.any():
            for i in range(nl):
                idxs = np.nonzero(spill_mask[i])[0]
                if not len(idxs):
                    continue
                s_hs = hashing.np_mix32(stage[0, i, idxs], p.seed)
                s_hd = hashing.np_mix32(stage[1, i, idxs],
                                        p.seed ^ 0x5BD1E995)
                self.ob.add(1, base + i,
                            f1s=s_hs & p.fp_mask, f1d=s_hd & p.fp_mask,
                            bs=(s_hs >> p.F1) % p.d1,
                            bd=(s_hd >> p.F1) % p.d1,
                            w=stage[2, i, idxs].view(np.float32)
                            .astype(np.float64),
                            t=stage[3, i, idxs])
        self._maybe_aggregate()

    # ------------------------------------------------------------------
    # aggregation cascade
    # ------------------------------------------------------------------

    def _maybe_aggregate(self) -> None:
        p = self.params
        cap = self.segments.level_cap
        level = 1
        while level + 1 <= p.max_levels:       # else fingerprints exhausted
            if cap is not None and level + 1 > cap:
                return          # hierarchy stops at the segment roots so
                #                 every sealed segment stays a complete,
                #                 independently evictable subtree
            pool = self.pools[level - 1]
            parent_n = self.pools[level].total if level < len(self.pools) \
                else 0
            n_ready = pool.total // p.theta - parent_n
            if n_ready <= 0:
                return
            if level >= len(self.pools):
                # the leaf closings that triggered this cascade already
                # bumped _version this drain
                self.pools.append(  # higgslint: disable=R5
                    _LevelPool(p.d(level + 1), p.b, self.device))
            self._build_parents_fused(level, parent_n, n_ready)
            level += 1

    def _build_parents_fused(self, level: int, u0: int, m: int) -> None:
        """Build the ``m`` ready parents at ``level`` on the device
        straight from the child slab rows into the parent slab rows; only
        the spill mask (and the spilled items' columns, when any) return
        to the host overflow store."""
        ob = self._gather_child_obs_stacked(level, u0, m)
        spill_h, spilled = self._pipeline.aggregate(
            self.pools[level - 1], self.pools[level], level, u0, m, ob)
        if spilled is None:
            return
        off = np.concatenate([[0], np.cumsum(spill_h.sum(axis=1))])
        for i in range(m):
            lo, hi = int(off[i]), int(off[i + 1])
            if hi > lo:
                self.ob.add(level + 1, u0 + i,
                            **{k: v[lo:hi] for k, v in spilled.items()},
                            t=np.zeros((hi - lo,), np.uint32))

    def _gather_child_obs_stacked(self, level: int, u0: int, m: int):
        """Overflow columns for ``m`` theta-blocks of children as stacked
        (m, ob_pad) host arrays; ``None`` when no child has OB entries."""
        theta = self.params.theta
        recs = [self.ob.get(level, c)
                for c in range(u0 * theta, (u0 + m) * theta)]
        totals = [sum(len(r["w"]) for r in recs[i * theta:(i + 1) * theta]
                      if r) for i in range(m)]
        if not any(totals):
            return None
        pad = max(16, 1 << max(0, (max(totals) - 1).bit_length()))
        out = {k: np.zeros((m, pad), np.uint32)
               for k in ("f1s", "f1d", "bs", "bd")}
        out["w"] = np.zeros((m, pad), np.float32)
        out["valid"] = np.zeros((m, pad), bool)
        for i in range(m):
            off = 0
            for rec in recs[i * theta:(i + 1) * theta]:
                if not rec:
                    continue
                n = len(rec["w"])
                for k in ("f1s", "f1d", "bs", "bd"):
                    out[k][i, off:off + n] = rec[k]
                out["w"][i, off:off + n] = rec["w"]
                out["valid"][i, off:off + n] = True
                off += n
        return out

    # ------------------------------------------------------------------
    # temporal lifecycle: sealing, eviction, coarsening compaction
    # ------------------------------------------------------------------

    def _lifecycle(self) -> None:
        """Seal completed segments, then enforce the retention policy.

        Runs after every drain (and on flush).  Everything here is a
        deterministic function of the closed-leaf sequence alone, never
        of insert batching.
        """
        st = self.segments
        while st.can_seal():
            i0 = st.n_sealed * st.seg_leaves - st.fine_base_leaf
            st.seal(int(self._leaves.starts[i0]),
                    int(self._leaves.ends[i0 + st.seg_leaves - 1]))
        pol = self.params.retention
        if pol.kind == "window":
            expire = self._t_last - pol.t_horizon
            while st.records and st.records[0].t_end < expire:
                self._evict_front()
        elif pol.kind == "budget":
            while self.space_bytes() > pol.max_bytes:
                if st.n_coarse < len(st.records):
                    self._coarsen_oldest_fine()
                elif st.records:
                    self._evict_front()     # every old segment is already
                    #                         coarse: drop roots, oldest
                    #                         first
                else:
                    break                   # only the active region is
                    #                         left: the budget's floor

    def _drop_segment_levels(self, lo_level: int, hi_level: int) -> None:
        """Reclaim one segment's nodes (and overflow keys) at levels
        ``lo_level..hi_level``: always the oldest retained prefix at each
        level, which keeps pool slots contiguous.  The pools slide their
        retained suffix on the device."""
        st = self.segments
        # _evict_front/_coarsen_oldest_fine (the only callers) bump
        # _version once per reclaimed segment
        for lvl in range(lo_level, hi_level + 1):
            pool = self.pools[lvl - 1]
            cnt = st.nodes_per_segment(lvl)
            for node in range(pool.base, pool.base + cnt):
                self.ob.drop(lvl, node)  # higgslint: disable=R5
            pool.drop_prefix(cnt)  # higgslint: disable=R5

    def _evict_front(self) -> None:
        """Evict the oldest retained segment wholesale: its slabs at
        every resident level, its overflow keys, and (for fine
        segments) its slice of the leaf-interval index."""
        st = self.segments
        seg = st.records.pop(0)
        if seg.coarse:
            self._drop_segment_levels(st.root_level, st.root_level)
            st.items_coarsened -= seg.n_items
        else:
            self._drop_segment_levels(1, st.root_level)
            self._leaves.drop_prefix(st.seg_leaves)
        st.n_evicted += 1
        st.items_evicted += seg.n_items
        self._version += 1                 # invalidate memoized plans

    def _coarsen_oldest_fine(self) -> None:
        """Collapse the oldest fine segment into its retained root: drop
        its leaves and mid-level ancestors (plus their overflow and
        interval keys), keep the level-(L+1) root and its overflow
        entries.  The segment's time range stays answerable at segment
        resolution through :meth:`boundary_search`."""
        st = self.segments
        seg = st.records[st.n_coarse]
        self._drop_segment_levels(1, st.levels)
        self._leaves.drop_prefix(st.seg_leaves)
        seg.coarse = True
        st.items_coarsened += seg.n_items
        self._version += 1

    def retention_stats(self) -> dict:
        """Lifecycle telemetry (also surfaced by the stream pipeline's
        retention hook)."""
        st = self.segments
        return {
            "policy": self.params.retention.kind,
            "segments_retained": len(st.records),
            "segments_coarse": st.n_coarse,
            "segments_evicted": st.n_evicted,
            "items_evicted": int(st.items_evicted),
            "items_coarsened": int(st.items_coarsened),
            "base_leaf": int(st.fine_base_leaf),
            "space_bytes": float(self.space_bytes()),
        }

    # ------------------------------------------------------------------
    # boundary search (paper Alg. 3) — canonical theta-ary decomposition
    # ------------------------------------------------------------------

    def boundary_search(self, ts: int, te: int):
        """Decompose [ts, te] into (plan, filtered_leaves):

        plan: dict level -> list of global node ids queried *without*
        time filter; filtered_leaves: global leaf ids queried *with* the
        [ts, te] filter.

        The search runs over the retained window: ``base`` (the global id
        of the first leaf still resident at leaf resolution) offsets every
        emitted id, and alignment is checked on global positions.  Ranges
        overlapping *coarsened* segments are also covered by those
        segments' retained roots, unfiltered: an overestimate at segment
        resolution, so the error stays one-sided.
        """
        if te < ts:
            return {}, []
        plan: dict[int, list[int]] = {}
        seg = self.segments
        base = seg.fine_base_leaf
        if seg.active:
            roots = seg.coarse_roots_overlapping(ts, te)
            if roots:
                plan[seg.root_level] = roots
        starts, ends = self.leaf_starts, self.leaf_ends
        n1 = len(starts)
        if n1 == 0:
            return plan, []
        li = int(np.searchsorted(starts, np.uint64(max(ts, 0)),
                                 "right")) - 1
        li = max(li, 0)
        ri = int(np.searchsorted(starts, np.uint64(max(te, 0)),
                                 "right")) - 1
        if ri < 0 or (li == ri and int(ends[li]) < ts):
            return plan, []                         # range between leaves
        # boundary leaves fully inside the range join the interior cover;
        # partially covered ones are queried with the exact time filter
        lo, hi = li, ri
        filtered = []
        if not (ts <= int(starts[li]) and te >= int(ends[li])):
            filtered.append(base + li)
            lo = li + 1
        if ri >= lo and not te >= int(ends[ri]):
            if ri != li:
                filtered.append(base + ri)
            hi = ri - 1
        theta = self.params.theta
        pos = lo
        while pos <= hi:
            lvl = 0
            blk = 1
            # largest aligned, existing block starting at pos
            while ((base + pos) % (blk * theta) == 0
                   and pos + blk * theta - 1 <= hi
                   and lvl + 2 <= len(self.pools)
                   and ((base + pos) // (blk * theta))
                   < self.pools[lvl + 1].total):
                blk *= theta
                lvl += 1
            plan.setdefault(lvl + 1, []).append((base + pos) // blk)
            pos += blk
        return plan, filtered

    def _query_coords(self, vid: np.ndarray, side: str):
        """Leaf fingerprints and chain bases of query vertices (host)."""
        p = self.params
        seed = p.seed if side == "s" else p.seed ^ 0x5BD1E995
        h = hashing.np_mix32(np.asarray(vid, np.uint32), seed)
        return h & np.uint32(p.fp_mask), (h >> np.uint32(p.F1)) % \
            np.uint32(p.d1)

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------

    def space_bytes(self) -> float:
        """Space per the paper's bit layout (Sec. V-A), not tensor
        overhead."""
        p = self.params
        total_bits = 0.0
        for level, pool in enumerate(self.pools, start=1):
            ent = p.leaf_entry_bits() if level == 1 else \
                p.node_entry_bits(level)
            total_bits += pool.n * p.d(level) ** 2 * p.b * ent
        for (level, _), rec in self.ob.data.items():
            ent = p.leaf_entry_bits() if level == 1 else \
                p.node_entry_bits(level)
            total_bits += len(rec["w"]) * ent
        total_bits += 64 * len(self.leaf_starts)    # B-tree keys
        return total_bits / 8.0 + self.segments.space_bytes()

    @property
    def n_levels(self) -> int:
        return len([p_ for p_ in self.pools if p_.n > 0])
