"""Windowed segment store: the temporal-lifecycle layer under HIGGS.

The append-only pools of :class:`~repro_torch.core.higgs.HiggsSketch` grow
monotonically with the stream; a production deployment on an unbounded
stream needs the storage layer to *forget*.  HIGGS's time-ordered leaves
make that cheap: old data is a contiguous prefix of theta^L-aligned
subtrees.  This module groups closed leaves into **sealed segments** —
each spanning exactly ``theta ** segment_levels`` leaves and owning its
leaf slab, its full ancestor closure up to one level-(L+1) root node,
its overflow-store keys, and its slice of the leaf-interval index — and
tracks the window bookkeeping that lets the sketch translate between
*global* node ids (stable across the stream's lifetime; what the
planner, boundary search, and overflow store speak) and *physical* pool
slots (the retained window only).

The store itself holds pure host metadata; the pool/index/overflow
surgery lives in ``HiggsSketch._lifecycle`` so the storage mutation and
its ``structure_version`` bump stay in one place.  With
``retention="none"`` the store is dormant: no metadata is recorded, no
level cap applies, and the sketch behaves bit-identically to the
pre-lifecycle engine (the CI baselines' exact structure counters rely
on this).

Segment states:

* **fine** — fully resident: leaves, ancestors, root, overflow keys.
* **coarse** — only the level-(L+1) root (and its overflow entries)
  remain; ranges overlapping the segment are answered from the root at
  segment resolution (an overestimate for partial overlap — one-sided,
  like every HIGGS estimate).
* **evicted** — nothing remains; the segment's mass is forgotten.

Records are kept oldest-first and the coarse prefix invariant holds:
``records[:n_coarse]`` are coarse, the rest fine.  Coarsening always
applies to the oldest fine segment and (budget-)eviction only to the
oldest coarse one, so per-level pool prefixes stay contiguous.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.params import HiggsParams

# space accounting per retained segment record: base_leaf + two 64-bit
# interval keys + item count + state flag, per the paper-style layout
SEGMENT_META_BYTES = 40.0


@dataclasses.dataclass
class Segment:
    """One sealed theta^L-aligned subtree of the stream."""

    base_leaf: int      # global id of the segment's first leaf
    n_leaves: int       # theta ** segment_levels (fixed at seal time)
    t_start: int        # first leaf's start key
    t_end: int          # last leaf's end key
    n_items: int        # stream items the segment's leaves absorbed
    coarse: bool = False

    def overlaps(self, ts: int, te: int) -> bool:
        return not (self.t_end < ts or self.t_start > te)

    def to_json(self) -> list:
        return [int(self.base_leaf), int(self.n_leaves), int(self.t_start),
                int(self.t_end), int(self.n_items), bool(self.coarse)]

    @classmethod
    def from_json(cls, rec: list) -> "Segment":
        base, n, t0, t1, items, coarse = rec
        return cls(int(base), int(n), int(t0), int(t1), int(items),
                   bool(coarse))


class SegmentStore:
    """Lifecycle metadata for one :class:`HiggsSketch`.

    Tracks the sealed-segment records, the per-leaf item counts of the
    not-yet-sealed tail (needed to report how many stream items each
    evicted segment carried), and the eviction counters that define the
    global-id bases of every storage layer.
    """

    def __init__(self, params: HiggsParams):
        self.policy = params.retention
        self.theta = params.theta
        self.levels = params.segment_levels            # L
        self.seg_leaves = params.theta ** params.segment_levels
        self.records: list[Segment] = []               # retained, oldest first
        self.n_evicted = 0
        self.items_evicted = 0                         # forgotten entirely
        self.items_coarsened = 0                       # segment-resolution only
        self._tail_items: list[int] = []               # unsealed closed leaves

    # ------------------------------------------------------------------
    # derived views
    # ------------------------------------------------------------------

    @property
    def active(self) -> bool:
        return self.policy.active

    @property
    def level_cap(self) -> int | None:
        """Highest tree level the aggregation cascade may build.

        With a live policy the hierarchy stops at the segment roots
        (level L+1): every sealed segment is then a complete subtree
        with exactly one root, so eviction and coarsening never orphan
        a higher ancestor spanning multiple segments."""
        return self.levels + 1 if self.active else None

    @property
    def root_level(self) -> int:
        return self.levels + 1

    @property
    def n_coarse(self) -> int:
        for i, rec in enumerate(self.records):
            if not rec.coarse:
                return i
        return len(self.records)

    @property
    def n_sealed(self) -> int:
        """Segments ever sealed (evicted + retained)."""
        return self.n_evicted + len(self.records)

    @property
    def fine_base_leaf(self) -> int:
        """Global id of the first leaf still resident at leaf
        resolution — the offset threaded through boundary search and the
        leaf-interval index."""
        if not self.active:
            return 0
        return (self.n_evicted + self.n_coarse) * self.seg_leaves

    @property
    def items_dropped(self) -> int:
        """Stream items no longer resident at leaf resolution; the
        retained fine suffix starts at this stream position."""
        return self.items_evicted + self.items_coarsened

    def nodes_per_segment(self, level: int) -> int:
        """Nodes a sealed segment owns at a 1-based tree level."""
        return self.theta ** (self.levels - level + 1)

    # ------------------------------------------------------------------
    # sealing
    # ------------------------------------------------------------------

    def on_leaves(self, counts) -> None:
        """Record the item counts of newly closed leaves (in order)."""
        if self.active:
            self._tail_items.extend(int(c) for c in counts)

    def can_seal(self) -> bool:
        return self.active and len(self._tail_items) >= self.seg_leaves

    def seal(self, t_start: int, t_end: int) -> Segment:
        """Seal the oldest ``seg_leaves`` unsealed leaves into a record."""
        n_items = sum(self._tail_items[: self.seg_leaves])
        del self._tail_items[: self.seg_leaves]
        seg = Segment(base_leaf=(self.n_sealed) * self.seg_leaves,
                      n_leaves=self.seg_leaves, t_start=int(t_start),
                      t_end=int(t_end), n_items=n_items)
        self.records.append(seg)
        return seg

    # ------------------------------------------------------------------
    # query support
    # ------------------------------------------------------------------

    def coarse_roots_overlapping(self, ts: int, te: int) -> list[int]:
        """Global level-(L+1) node ids of coarse segments overlapping
        [ts, te].  Coarse roots are the oldest retained roots, so the
        global id of ``records[i]``'s root is ``n_evicted + i``."""
        return [self.n_evicted + i
                for i, rec in enumerate(self.records[: self.n_coarse])
                if rec.overlaps(ts, te)]

    def space_bytes(self) -> float:
        """Metadata footprint of the retained records (0 when dormant,
        keeping legacy space accounting bit-exact)."""
        if not self.active:
            return 0.0
        return SEGMENT_META_BYTES * len(self.records)

    def epoch_stamp(self) -> dict:
        """Lifecycle position identifying a read epoch's window: two
        epochs with equal stamps (and equal ``structure_version``) see
        the same sealed prefix and the same retained fine suffix."""
        return {
            "n_sealed": int(self.n_sealed),
            "n_evicted": int(self.n_evicted),
            "n_coarse": int(self.n_coarse),
            "fine_base_leaf": int(self.fine_base_leaf),
        }

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def meta(self) -> dict:
        return {
            "records": [r.to_json() for r in self.records],
            "n_evicted": int(self.n_evicted),
            "items_evicted": int(self.items_evicted),
            "items_coarsened": int(self.items_coarsened),
            "tail_items": [int(c) for c in self._tail_items],
        }

    def load(self, meta: dict | None) -> None:
        """Overwrite with snapshot lifecycle state (policy/geometry come
        from the params this store was constructed with)."""
        if meta is None:
            return
        self.records = [Segment.from_json(r) for r in meta["records"]]
        self.n_evicted = int(meta["n_evicted"])
        self.items_evicted = int(meta["items_evicted"])
        self.items_coarsened = int(meta["items_coarsened"])
        self._tail_items = [int(c) for c in meta["tail_items"]]
