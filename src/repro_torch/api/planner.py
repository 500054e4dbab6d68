"""Batched query-plan engine for the HIGGS sketch (port of
``repro.api.planner``).

1. Lower the batch: Edge/Path/Subgraph queries become slices of one
   concatenated (src, dst) edge batch per distinct ``[ts, te]`` range
   (a *time-range class*); VertexQuery batches group by (range, direction).
2. Plan once per range class: ``boundary_search`` runs once per distinct
   range, memoized (LRU) until the next insertion mutates the tree.
3. Probe: an edge batch makes one K3 launch over all its (level, range
   class) entries, a vertex batch one K4 call per (level, range class);
   each reads the level pools' resident slabs through the plan's row
   index.  Then the host overflow blocks of the planned nodes are
   scanned, and the answers add up level by level in the reference's
   order.

``QueryStats.device_dispatches`` counts the (level, range class) probes,
as in the reference, however many launches carry them.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.api.queries import (EDGE_LOWERED, QueryBatch, QueryResult,
                                     QueryStats, VertexQuery)
from repro_torch.core import cmatrix
from repro_torch.kernels import probe as _pr

if TYPE_CHECKING:  # avoid a circular import; higgs imports this module
    from repro_torch.core.higgs import HiggsSketch


def _side_key(f1, base, F1: int) -> np.ndarray:
    """One vertex side ``(f1, base)`` as a 32-bit key: ``base`` holds the
    hash bits above the ``F1`` fingerprint bits, so the two fit in 32."""
    return np.asarray(f1, np.uint64) | (np.asarray(base, np.uint64)
                                        << np.uint64(F1))


def _join_sums(rec_keys: np.ndarray, rec_w: np.ndarray,
               q_keys: np.ndarray) -> np.ndarray:
    """For each query key, the float64 sum of ``rec_w`` over records with
    an equal key (0 where none).

    The reference compares every query with every record (a dense
    ``(q, n)`` mask), which does not fit in memory once the top-level
    overflow blocks of a multi-million-edge stream hold millions of
    entries; a sort join gives the same sums (in another order: equal on
    integer weights, within float64 rounding otherwise).
    """
    out = np.zeros((len(q_keys),), np.float64)
    if len(rec_keys) == 0 or len(q_keys) == 0:
        return out
    uk, inv = np.unique(rec_keys, return_inverse=True)
    sums = np.bincount(inv.reshape(-1), weights=rec_w, minlength=len(uk))
    pos = np.minimum(np.searchsorted(uk, q_keys), len(uk) - 1)
    return np.where(uk[pos] == q_keys, sums[pos], 0.0)


class QueryPlanner:
    """Executes typed query batches against one :class:`HiggsSketch`.
    ``kernels=False`` probes with the plain versions of K3/K4."""

    # memoized plans are tiny, but a read-only phase serving arbitrarily
    # many distinct ranges must not grow memory without bound
    MAX_CACHED_PLANS = 1024

    def __init__(self, sketch: "HiggsSketch", kernels: bool = True):
        self.sketch = sketch
        self.lifetime = QueryStats()       # accumulated across executions
        self._plan_cache: dict[tuple[int, int], tuple[dict, list]] = {}
        self._cache_version = -1
        self._edge_probe_levels = (_pr.edge_probe_levels if kernels
                                   else _pr.edge_probe_levels_plain)
        self._vertex_probe = (_pr.vertex_probe if kernels
                              else _pr.vertex_probe_plain)

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------

    def plan(self, ts: int, te: int, stats: QueryStats):
        """Memoized boundary search; invalidated when the tree mutates.
        Eviction is LRU: a hit re-inserts the plan at the back."""
        version = self.sketch.structure_version
        if version != self._cache_version:
            self._plan_cache = {}
            self._cache_version = version
        key = (int(ts), int(te))
        cached = self._plan_cache.pop(key, None)
        if cached is None:
            cached = self.sketch.boundary_search(ts, te)
            if len(self._plan_cache) >= self.MAX_CACHED_PLANS:
                self._plan_cache.pop(next(iter(self._plan_cache)))
            stats.boundary_searches += 1
            stats.plan_cache_misses += 1
        else:
            stats.plan_cache_hits += 1
        self._plan_cache[key] = cached
        return cached

    def invalidate(self) -> None:
        """Drop every memoized plan and re-seed the cache epoch from the
        sketch's current ``structure_version`` (after a state load)."""
        self._plan_cache = {}
        self._cache_version = self.sketch.structure_version

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def execute(self, queries: QueryBatch) -> QueryResult:
        stats = QueryStats(n_queries=len(queries))
        values: list = [None] * len(queries)

        edge_groups: dict[tuple[int, int], list] = {}
        vertex_groups: dict[tuple[int, int, str], list] = {}
        for qi, q in enumerate(queries):
            if isinstance(q, EDGE_LOWERED):
                src, dst = q.edge_arrays()
                edge_groups.setdefault((q.ts, q.te), []).append(
                    (qi, src, dst))
            elif isinstance(q, VertexQuery):
                vertex_groups.setdefault((q.ts, q.te, q.direction),
                                         []).append((qi, q.v))
            else:
                raise TypeError(
                    f"unsupported query type: {type(q).__name__}")

        for (ts, te), jobs in edge_groups.items():
            src = np.concatenate([s for _, s, _ in jobs])
            dst = np.concatenate([d for _, _, d in jobs])
            out = self._edge_batch(src, dst, ts, te, stats)
            off = 0
            for qi, s, _ in jobs:
                values[qi] = queries[qi].reduce(out[off:off + len(s)])
                off += len(s)

        for (ts, te, direction), jobs in vertex_groups.items():
            v = np.concatenate([x for _, x in jobs])
            out = self._vertex_batch(v, ts, te, direction, stats)
            off = 0
            for qi, x in jobs:
                values[qi] = queries[qi].reduce(out[off:off + len(x)])
                off += len(x)

        self.lifetime.merge(stats)
        return QueryResult(values, stats,
                           epoch=int(self.sketch.structure_version))

    def _to_device(self, *arrays):
        dev = self.sketch.device
        return [torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                for a in arrays]

    def _edge_batch(self, src, dst, ts, te, stats: QueryStats) -> np.ndarray:
        """One K3 launch over the plan's (level, class) entries, one copy
        of the partials back; then, in the reference's order, each
        entry's partial and its overflow-block scan add into the
        answers."""
        sk = self.sketch
        out = np.zeros((len(src),), np.float64)
        if len(src) == 0:
            return out
        p = sk.params
        r = p.r if p.use_mmb else 1
        f1s, bs = sk._query_coords(src, "s")
        f1d, bd = sk._query_coords(dst, "d")
        f1s_t, bs_t, f1d_t, bd_t = self._to_device(f1s, bs, f1d, bd)
        i32 = torch.int32
        leaf = (f1s_t.to(i32),
                cmatrix.chain_from_base(bs_t, r, p.d1).to(i32),
                f1d_t.to(i32),
                cmatrix.chain_from_base(bd_t, r, p.d1).to(i32))
        plan, filtered = self.plan(ts, te, stats)
        steps = [(level, ids, False) for level, ids in sorted(plan.items())]
        if filtered:
            steps.append((1, filtered, True))
        entries, row_of = [], []
        for level, ids, filter_time in steps:
            entry = self._edge_entry(level, ids, ts, te, filter_time,
                                     len(src), stats)
            row_of.append(len(entries) if entry is not None else None)
            if entry is not None:
                entries.append(entry)
        if entries:
            partial = self._edge_probe_levels(entries, *leaf, params=p)
            partial = partial.cpu().numpy().astype(np.float64)
        for (level, ids, filter_time), row in zip(steps, row_of):
            if row is not None:
                out += partial[row]
            out += self._ob_edge(level, ids, f1s, bs, f1d, bd, ts, te,
                                 filter_time, stats)
        return out

    def _vertex_batch(self, v, ts, te, direction,
                      stats: QueryStats) -> np.ndarray:
        sk = self.sketch
        out = np.zeros((len(v),), np.float64)
        if len(v) == 0:
            return out
        side = "s" if direction == "out" else "d"
        f1, base = sk._query_coords(v, side)
        coords = self._to_device(f1, base)
        plan, filtered = self.plan(ts, te, stats)
        for level, ids in sorted(plan.items()):
            out += self._probe_level_vertex(level, ids, coords, ts, te,
                                            direction, False, stats)
            out += self._ob_vertex(level, ids, f1, base, ts, te, direction,
                                   False, stats)
        if filtered:
            out += self._probe_level_vertex(1, filtered, coords, ts, te,
                                            direction, True, stats)
            out += self._ob_vertex(1, filtered, f1, base, ts, te, direction,
                                   True, stats)
        return out

    # -- device probes: K3 entries, one K4 call per (level, class) -------

    def _edge_entry(self, level, ids, ts, te, filter_time, q,
                    stats: QueryStats):
        """The K3 entry of one (level, class), or None if nothing is
        there to probe."""
        sk = self.sketch
        if len(ids) == 0 or level > len(sk.pools) or \
                sk.pools[level - 1].n == 0:
            return None
        p = sk.params
        r = p.r if p.use_mmb else 1
        stats.device_dispatches += 1
        stats.buckets_probed += len(ids) * r * r * q
        pool = sk.pools[level - 1]
        return _pr.EdgeEntry(pool.device_view(), pool.slots_of(ids),
                             np.ones((len(ids),), bool), level, int(ts),
                             int(te), filter_time)

    def _probe_level_vertex(self, level, ids, coords, ts, te, direction,
                            filter_time, stats: QueryStats):
        sk = self.sketch
        if len(ids) == 0 or level > len(sk.pools) or \
                sk.pools[level - 1].n == 0:
            return 0.0
        p = sk.params
        r = p.r if p.use_mmb else 1
        f1, base = coords
        q = len(f1)
        stats.device_dispatches += 1
        stats.buckets_probed += len(ids) * r * p.d(level) * q
        pool = sk.pools[level - 1]
        idx, mask = pool.gather_ids(ids)
        fv, rows = cmatrix.coords_at_level(f1, base, level, p)
        res = self._vertex_probe(pool.device_view(), idx, mask,
                                 fv.to(torch.int32), rows.to(torch.int32),
                                 int(ts), int(te), direction=direction,
                                 match_time=filter_time)
        return res.cpu().numpy().astype(np.float64)

    # -- host-side overflow-block probes ---------------------------------

    def _ob_scan(self, level, ids, key_of, q_keys, ts, te, filter_time,
                 stats: QueryStats):
        ob = self.sketch.ob
        out = np.zeros((len(q_keys),), np.float64)
        for nid in ids:
            rec = ob.get(level, int(nid))
            if not rec:
                continue
            stats.ob_probes += 1
            keys, w = key_of(rec), rec["w"]
            if filter_time:
                tok = (rec["t"] >= ts) & (rec["t"] <= te)
                keys, w = keys[tok], w[tok]
            out += _join_sums(keys, w, q_keys)
        return out

    def _ob_edge(self, level, ids, f1s, bs, f1d, bd, ts, te, filter_time,
                 stats: QueryStats):
        F1 = self.sketch.params.F1

        def key_of(rec):
            return (_side_key(rec["f1s"], rec["bs"], F1) << np.uint64(32)) \
                | _side_key(rec["f1d"], rec["bd"], F1)

        q_keys = key_of({"f1s": f1s, "bs": bs, "f1d": f1d, "bd": bd})
        return self._ob_scan(level, ids, key_of, q_keys, ts, te,
                             filter_time, stats)

    def _ob_vertex(self, level, ids, f1, base, ts, te, direction,
                   filter_time, stats: QueryStats):
        F1 = self.sketch.params.F1
        fk, bk = ("f1s", "bs") if direction == "out" else ("f1d", "bd")

        def key_of(rec):
            return _side_key(rec[fk], rec[bk], F1)

        return self._ob_scan(level, ids, key_of, _side_key(f1, base, F1),
                             ts, te, filter_time, stats)
