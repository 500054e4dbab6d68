"""Retention (the segment lifecycle) in the port against the JAX
reference: the same Lkml-shaped stream goes through the reference's
windowed or budgeted ``HiggsSketch`` (``insert_backend="pallas"``
interpreted, host pools, the reference's bit baseline) and the port's on
the CPU.  Every pool, empty ones included, matches bit for bit with its
``n`` and ``base``; so do the overflow store, the leaf index, the segment
metadata, ``retention_stats()``, the boundary-search plans and every
answer.  The port's windowed sketch also equals a fresh port sketch on
the retained suffix, and passes the reference's numpy sanitizer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.analysis import sanitize  # noqa: E402
from repro.api import queries as rq  # noqa: E402
from repro.core.higgs import HiggsSketch as RefSketch  # noqa: E402
from repro.core.params import HiggsParams as RefParams  # noqa: E402
from repro_torch import (HiggsParams, HiggsSketch,  # noqa: E402
                         RetentionPolicy)
from repro_torch.api import queries as tq  # noqa: E402
from repro_torch.stream.generator import lkml_like_stream  # noqa: E402

FIELDS = ("fp_s", "fp_d", "w", "t", "idx")
SMALL = dict(d1=4, F1=14, b=2, r=2)       # tests/test_torch_sketch.py
T_SPAN = 1 << 27                          # lkml_like_stream's time span
N = 3100                                  # 115 leaves: 7 segments + tail
BATCH = 700


@pytest.fixture(scope="module")
def stream():
    return lkml_like_stream(N, seed=3)


def build(kw, stream, port_only=False):
    """Reference (unless ``port_only``) and port sketches fed the same
    batches, then flushed."""
    port = HiggsSketch(HiggsParams(**kw), device="cpu")
    sks = [port]
    if not port_only:
        sks.insert(0, RefSketch(RefParams(
            insert_backend="pallas", pool_storage="host", interpret=True,
            batched_ingest=True, **kw)))
    for lo in range(0, len(stream[0]), BATCH):
        for sk in sks:
            sk.insert(*(a[lo:lo + BATCH] for a in stream))
    for sk in sks:
        sk.flush()
    return sks


def assert_pools_equal(a, b, nonempty_only=False):
    """Pools level by level, bit for bit; ``nonempty_only`` compares the
    levels where ``b`` holds nodes and requires ``a`` empty above them
    (a fresh suffix build never creates a pool whose nodes a windowed
    sketch evicted)."""
    if nonempty_only:
        live = [i for i, p in enumerate(b.pools) if p.n]
        assert all(p.n == 0 for p in a.pools[len(b.pools):])
    else:
        assert len(a.pools) == len(b.pools)
        assert [p.base for p in a.pools] == [p.base for p in b.pools]
        live = range(len(a.pools))
    for i in live:
        pa, pb = a.pools[i], b.pools[i]
        assert pa.n == pb.n, f"L{i + 1}"
        if pa.n == 0:
            continue
        for name in FIELDS:
            np.testing.assert_array_equal(
                pa.arrs[name][:pa.n].view(np.uint32),
                pb.arrs[name][:pb.n].view(np.uint32),
                err_msg=f"L{i + 1}/{name}")


def assert_state_equal(ref, port):
    np.testing.assert_array_equal(port.leaf_starts, ref.leaf_starts)
    np.testing.assert_array_equal(port.leaf_ends, ref.leaf_ends)
    assert port.n_items == ref.n_items
    assert port.structure_version == ref.structure_version
    assert_pools_equal(port, ref)
    dr, dt = ref.ob.data, port.ob.data
    assert list(dt) == list(dr)                  # same keys, same order
    for key in dr:
        for f in dr[key]:
            np.testing.assert_array_equal(dt[key][f], dr[key][f],
                                          err_msg=f"ob{key}/{f}")
    assert port.segments.meta() == ref.segments.meta()
    assert port.retention_stats() == ref.retention_stats()
    assert port.space_bytes() == ref.space_bytes()


def ranges(sk):
    """A grid over the whole span: evicted, coarse and retained regions,
    ranges across their borders, one leaf-cutting range, and the
    newest data."""
    T = T_SPAN
    cut = int(sk.leaf_ends[len(sk.leaf_ends) // 2]) - 3 \
        if len(sk.leaf_ends) else T // 2
    out = [(0, T), (T // 8, T // 4), (T // 3, T // 2), (T // 2, 3 * T // 4),
           (3 * T // 4, T), (T - T // 64, T), (cut, cut + T // 97),
           (T + 10, T + 1000), (T // 2, T // 4)]
    out += [(int(r.t_start), int(r.t_end)) for r in sk.segments.records]
    out += [(int(r.t_start) + 5, int(r.t_end) + 1000)
            for r in sk.segments.records[:2]]
    return out


def batches(stream, rngs):
    src, dst = stream[0], stream[1]
    pick = np.arange(0, len(src), 41)
    out = []
    for mod in (rq, tq):
        qs = []
        for ts, te in rngs:
            qs += [mod.EdgeQuery(src[-48:], dst[-48:], ts, te),
                   mod.EdgeQuery(src[pick], dst[pick], ts, te),
                   mod.VertexQuery(src[-32:], ts, te, "out"),
                   mod.VertexQuery(dst[:32], ts, te, "in"),
                   mod.PathQuery(np.concatenate([src[-5:], dst[-1:]]), ts,
                                 te),
                   mod.SubgraphQuery(np.stack([src[-12:], dst[-12:]], 1),
                                     ts, te)]
        out.append(qs)
    return out


def assert_same_answers(a, b, stream, rngs, counters=True):
    """Equal answers of ``a`` (the reference, or a port sketch when
    ``counters`` is off) and the port's ``b``, and equal planner
    counters."""
    qa, qb = batches(stream, rngs)
    if not counters:
        qa = qb
    ra, rb = a.query(qa), b.query(qb)
    for i, (x, y) in enumerate(zip(ra.values, rb.values)):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                      err_msg=f"query {i}")
    if counters:
        for f in ("boundary_searches", "plan_cache_hits", "device_dispatches",
                  "buckets_probed", "ob_probes"):
            assert getattr(rb.stats, f) == getattr(ra.stats, f), f
    return rb


def exact(stream, kind, keys_a, keys_b, ts, te):
    src, dst, w, t = stream
    inr = (t >= ts) & (t <= te)
    if kind == "edge":
        return np.array([w[inr & (src == s) & (dst == d)].sum()
                         for s, d in zip(keys_a, keys_b)])
    side = src if kind == "out" else dst
    return np.array([w[inr & (side == v)].sum() for v in keys_a])


@pytest.fixture(scope="module", params=[4, 2], ids=["quarter", "half"])
def window_pair(request, stream):
    return build(dict(SMALL, retention=f"window:{T_SPAN // request.param}"),
                 stream)


def test_window_matches_reference(window_pair, stream):
    ref, port = window_pair
    st = port.segments
    assert st.n_evicted > 0 and st.records, "no eviction reached"
    assert port.pools[0].base > 0
    assert_state_equal(ref, port)
    assert_same_answers(ref, port, stream, ranges(port))


@pytest.fixture(scope="module")
def budget_pair(stream):
    return build(dict(SMALL, retention="budget:30000"), stream)


def test_budget_matches_reference(budget_pair, stream):
    ref, port = budget_pair
    stats = port.retention_stats()
    assert stats["segments_coarse"] > 0 and stats["segments_evicted"] > 0
    assert port.space_bytes() <= 30_000
    assert_state_equal(ref, port)
    assert_same_answers(ref, port, stream, ranges(port))
    # coarse roots answer their ranges one-sidedly: every vertex's
    # full-range out-mass is at least what the held items carry
    st = port.segments
    held = tuple(a[st.items_evicted:port.n_items - port._buf_len]
                 for a in stream)
    v = np.unique(stream[0])[:64]
    got = port.query([tq.VertexQuery(v, 0, T_SPAN, "out")]).values[0]
    assert (np.asarray(got) >= exact(held, "out", v, None, 0, T_SPAN)).all()


def test_boundary_search_plans_match_reference(window_pair, budget_pair):
    T = T_SPAN
    grid = [(a * T // 16, b * T // 16) for a in range(17)
            for b in range(a, 17, 3)]
    for ref, port in (window_pair, budget_pair):
        rngs = grid + ranges(port)
        coarse = [r for r in rngs
                  if port.segments.coarse_roots_overlapping(*r)]
        assert bool(coarse) == (port is budget_pair[1])
        for ts, te in rngs:
            plan_r, filt_r = ref.boundary_search(ts, te)
            plan_t, filt_t = port.boundary_search(ts, te)
            assert {k: list(v) for k, v in plan_t.items()} == \
                {k: list(v) for k, v in plan_r.items()}, (ts, te)
            assert list(filt_t) == list(filt_r), (ts, te)


@pytest.mark.parametrize("levels", [1, 2])
def test_cascade_stops_at_segment_roots(stream, levels):
    """With a live policy the hierarchy stops at level L+1 (the segment
    roots), where the unbounded sketch grows higher."""
    kw = dict(SMALL, segment_levels=levels, retention=f"window:{T_SPAN}")
    ref, port = build(kw, stream)
    free, = build(dict(SMALL), stream, port_only=True)
    assert len(port.pools) == levels + 1 < len(free.pools)
    assert port.pools[-1].total == port.segments.n_sealed
    assert_state_equal(ref, port)


def test_window_equals_fresh_suffix_build(stream):
    kw = dict(SMALL, retention=RetentionPolicy.window(T_SPAN // 3))
    win, = build(kw, stream, port_only=True)
    drop = win.segments.items_dropped
    assert drop > 0
    suffix = tuple(a[drop:] for a in stream)
    fresh, = build(kw, suffix, port_only=True)
    np.testing.assert_array_equal(win.leaf_starts, fresh.leaf_starts)
    np.testing.assert_array_equal(win.leaf_ends, fresh.leaf_ends)
    assert_pools_equal(win, fresh, nonempty_only=True)
    rngs = ranges(win)
    res = assert_same_answers(fresh, win, stream, rngs, counters=False)
    # one-sided against the exact answers over the retained items
    _, qt = batches(stream, rngs)
    for q, got in zip(qt, res.values):
        if isinstance(q, tq.EdgeQuery):
            want = exact(suffix, "edge", q.src, q.dst, q.ts, q.te)
        elif isinstance(q, tq.VertexQuery):
            want = exact(suffix, q.direction, q.v, None, q.ts, q.te)
        else:
            continue
        assert (np.asarray(got) >= want).all()


def test_sanitizer_invariants_hold_on_port_sketches(window_pair,
                                                    budget_pair, stream):
    """The reference's numpy sanitizer, called on port sketches: pool
    bases, interval cover, cascade, overflow ownership, mass."""
    sanitize.set_enabled(True)
    try:
        for _, port in (window_pair, budget_pair):
            sanitize.maybe_check(port)
        kw = dict(SMALL, retention=RetentionPolicy.window(T_SPAN // 4))
        sk = HiggsSketch(HiggsParams(**kw), device="cpu")
        for lo in range(0, 2000, 350):            # after every drain
            sk.insert(*(a[lo:lo + 350] for a in stream))
            sanitize.maybe_check(sk)
        sk.pools[1].arrs["w"][0, 0, 0, 0] += 1.0  # a CPU view: corrupts
        with pytest.raises(sanitize.SanitizeError, match="mass"):
            sanitize.maybe_check(sk)
    finally:
        sanitize.set_enabled(None)
