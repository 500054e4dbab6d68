"""The port's main path as a whole against the JAX reference: the same
stream goes through the reference ``HiggsSketch`` (``insert_backend=
"pallas"`` interpreted, host pools — the reference's bit baseline for
its device pools) and the port's ``HiggsSketch`` on the CPU.  Every
level's pool, the leaf intervals and the overflow store match bit for
bit; answers to every query kind match exactly (integer weights), and so
do the planner's dispatch and bucket counters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.api import queries as rq  # noqa: E402
from repro.core.higgs import HiggsSketch as RefSketch  # noqa: E402
from repro.core.params import HiggsParams as RefParams  # noqa: E402
from repro_torch import HiggsParams, HiggsSketch  # noqa: E402
from repro_torch.api import queries as tq  # noqa: E402
from repro_torch.stream.generator import lkml_like_stream  # noqa: E402

FIELDS = ("fp_s", "fp_d", "w", "t", "idx")
SMALL = dict(d1=4, F1=14, b=2, r=2)       # tests/test_device_pool.py:24


def build_pair(kw, stream, cuts=(), flush_at=None):
    """Reference and port sketches fed the same inserts (split at
    ``cuts``; flushed after the batch ending at ``flush_at`` and at the
    end)."""
    ref = RefSketch(RefParams(insert_backend="pallas", pool_storage="host",
                              interpret=True, batched_ingest=True, **kw))
    port = HiggsSketch(HiggsParams(insert_backend="pallas",
                                   batched_ingest=True, **kw), device="cpu")
    n = len(stream[0])
    marks = sorted({0, n, *(min(c, n) for c in cuts)})
    for lo, hi in zip(marks[:-1], marks[1:]):
        for sk in (ref, port):
            sk.insert(*(a[lo:hi] for a in stream))
            if hi == flush_at:
                sk.flush()
    for sk in (ref, port):
        sk.flush()
    return ref, port


def assert_state_equal(ref, port):
    np.testing.assert_array_equal(ref.leaf_starts, port.leaf_starts)
    np.testing.assert_array_equal(ref.leaf_ends, port.leaf_ends)
    assert ref.n_items == port.n_items
    assert [p.n for p in ref.pools] == [p.n for p in port.pools]
    assert [p.base for p in ref.pools] == [p.base for p in port.pools]
    for lvl, (pr, pt) in enumerate(zip(ref.pools, port.pools), start=1):
        ar, at = pr.arrs, pt.arrs
        for name in FIELDS:
            np.testing.assert_array_equal(
                at[name][:pt.n].view(np.uint32),
                ar[name][:pr.n].view(np.uint32), err_msg=f"L{lvl}/{name}")
    dr, dt = ref.ob.data, port.ob.data
    assert list(dr) == list(dt)                  # same keys, same order
    for key in dr:
        for f in dr[key]:
            np.testing.assert_array_equal(dt[key][f], dr[key][f],
                                          err_msg=f"ob{key}/{f}")
    assert ref.space_bytes() == port.space_bytes()
    assert ref.n_levels == port.n_levels


def query_batches(stream, t_lo, t_hi, cut):
    """Equivalent reference / port batches: every query kind at a full,
    a partial, a leaf-cutting and two empty ranges."""
    src, dst = stream[0], stream[1]
    pick = np.arange(0, len(src), 37)
    span = t_hi - t_lo
    ranges = [(t_lo, t_hi),                       # full
              (t_lo + span // 4, t_lo + 3 * span // 4),   # partial
              (cut, cut + max(span // 97, 1)),     # inside / across leaves
              (t_hi + 10, t_hi + 1000),            # after the stream
              (t_hi, t_lo)]                        # inverted: empty
    batches = []
    for mod in (rq, tq):
        qs = []
        for ts, te in ranges:
            qs += [mod.EdgeQuery(src[:48], dst[:48], ts, te),
                   mod.EdgeQuery(src[pick], dst[(pick * 7) % len(dst)], ts,
                                 te),
                   mod.VertexQuery(src[:32], ts, te, "out"),
                   mod.VertexQuery(dst[:32], ts, te, "in"),
                   mod.PathQuery(np.concatenate([src[:5], dst[5:6]]), ts, te),
                   mod.SubgraphQuery(np.stack([src[10:20], dst[10:20]], 1),
                                     ts, te)]
        batches.append(qs)
    return batches


def assert_same_answers(ref, port, stream, rtol=0.0):
    """Equal answers (``rtol`` > 0: within it, for float weights, which
    the two sum in other orders) and planner counters."""
    t = stream[3]
    cut = int(port.leaf_ends[len(port.leaf_ends) // 2]) - 3
    rqs, tqs = query_batches(stream, int(t[0]), int(t[-1]), cut)
    ra, ta = ref.query(rqs), port.query(tqs)
    for i, (x, y) in enumerate(zip(ra.values, ta.values)):
        if rtol:
            np.testing.assert_allclose(np.asarray(y), np.asarray(x),
                                       rtol=rtol, err_msg=f"query {i}")
        else:
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                          err_msg=f"query {i}")
    for f in ("boundary_searches", "plan_cache_hits", "plan_cache_misses",
              "device_dispatches", "buckets_probed", "ob_probes"):
        assert getattr(ta.stats, f) == getattr(ra.stats, f), f
    assert ta.stats.device_dispatches > 0
    # a second round hits the memoized plans in both (edge, out, in)
    ra2, ta2 = ref.query(rqs[:6]), port.query(tqs[:6])
    assert ta2.stats.plan_cache_hits == ra2.stats.plan_cache_hits == 3
    assert ta2.stats.boundary_searches == 0
    return ta


def small_stream(seed, n, nv, t_max):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nv, n).astype(np.uint32),
            rng.integers(0, nv, n).astype(np.uint32),
            rng.integers(1, 10, n).astype(np.float32),
            np.sort(rng.integers(0, t_max, n).astype(np.uint32)))


@pytest.mark.parametrize("seed,n,nv,t_max,cuts,flush_at", [
    (0, 700, 40, 3000, (123, 400), None),
    (1, 850, 64, 900, (77,), 77),          # mid-stream flush
    (2, 600, 20, 6, (300,), None),         # oversize equal-timestamp runs
])
def test_small_geometry_parity(seed, n, nv, t_max, cuts, flush_at):
    stream = small_stream(seed, n, nv, t_max)
    ref, port = build_pair(SMALL, stream, cuts, flush_at)
    assert_state_equal(ref, port)
    assert_same_answers(ref, port, stream)


@pytest.mark.parametrize("seed,nv", [(3, 4), (4, 9), (5, 12)])
def test_deep_cascade_with_overflow(seed, nv):
    # few vertices + long stream: heavy fingerprint collisions force
    # multi-level parent builds and overflow spill (the regime of
    # tests/test_device_pool.py::TestFusedAggregationCascade)
    stream = small_stream(seed, 900, nv, 2000)
    ref, port = build_pair(SMALL, stream, cuts=(450,))
    assert sum(p.n > 0 for p in port.pools[1:]) >= 2, "no cascade"
    assert any(lvl > 1 for lvl, _ in port.ob.data), "no parent spill"
    assert_state_equal(ref, port)
    assert_same_answers(ref, port, stream)


def case_stream(case):
    src, dst, w, t = small_stream(7, 800, 48, 2500)
    rng = np.random.default_rng(70)
    if case == "float_weights":
        w = rng.exponential(2.0, len(w)).astype(np.float32)
    elif case == "negative_weights":
        w = rng.integers(-6, 10, len(w)).astype(np.float32)
    elif case == "t_near_2_32":          # the latest ranges stay below 2^32
        t = t + np.uint32(2 ** 32 - 4000)
    return src, dst, w, t


PARITY_CASES = {
    "float_weights": {},
    "negative_weights": {},
    "theta_16": dict(theta=16),
    "no_mmb": dict(use_mmb=False),
    "b1_r1": dict(b=1, r=1),
    "r_eq_d1": dict(r=4),
    "t_near_2_32": {},
    "F1_5": dict(F1=5),                  # 3 fingerprint bits at level 3
    "interleaved": {},
}


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_sketch_parity_cases(case):
    """Beyond the integer-weight streams above: float and negative
    weights, other geometries, timestamps near 2^32, and queries between
    inserts (no flush), each at the SMALL geometry otherwise."""
    stream = case_stream(case)
    kw = {**SMALL, **PARITY_CASES[case]}
    rtol = 1e-6 if case == "float_weights" else 0.0
    if case != "interleaved":
        ref, port = build_pair(kw, stream, cuts=(300,))
        assert_state_equal(ref, port)
        assert_same_answers(ref, port, stream, rtol)
        return
    ref = RefSketch(RefParams(insert_backend="pallas", pool_storage="host",
                              interpret=True, batched_ingest=True, **kw))
    port = HiggsSketch(HiggsParams(insert_backend="pallas",
                                   batched_ingest=True, **kw), device="cpu")
    for lo, hi in ((0, 250), (250, 520), (520, 800)):
        for sk in (ref, port):
            sk.insert(*(a[lo:hi] for a in stream))
        assert_same_answers(ref, port, tuple(a[:hi] for a in stream))
    for sk in (ref, port):
        sk.flush()
    assert_state_equal(ref, port)
    assert_same_answers(ref, port, stream)


@pytest.fixture(scope="module")
def default_pair():
    stream = lkml_like_stream(20_000, seed=3)
    ref, port = build_pair({}, stream, cuts=(5000, 9001, 15000))
    return stream, ref, port


def test_default_geometry_state(default_pair):
    _, ref, port = default_pair
    assert port.params.d1 == 16 and port.params.chunk_size == 652
    assert port.n_levels >= 3 and port.ob.total_entries() > 0
    assert_state_equal(ref, port)


def test_default_geometry_answers(default_pair):
    stream, ref, port = default_pair
    res = assert_same_answers(ref, port, stream)
    # one-sided error on the stream's own edges (full range)
    assert (np.asarray(res.values[0]) >= 1.0).all()


def test_unported_configurations_raise():
    with pytest.raises(NotImplementedError, match="item 10"):
        HiggsSketch(HiggsParams(insert_backend="host"), device="cpu")


def test_level_pool_storage_contract():
    """Capacity doubling keeps fresh-node contents past ``n``; adopted
    in-place writes, global-id gathers and prefix drops line up."""
    from repro_torch.core.pool import _LevelPool
    pool = _LevelPool(4, 2, "cpu")
    assert pool.arrs is None and pool.total == 0
    pool.reserve(3)
    assert pool.cap == 4
    rows = pool.rows(0, 3)
    for i in range(3):
        rows.fp_s[i] = i
        rows.w[i] = 10.0 + i
    assert pool.adopt_slabs(pool.slabs, 3) == 0 and pool.n == 3
    pool.reserve(5)                                  # doubling keeps rows
    assert pool.cap == 8 and int(pool.slabs.fp_s[2, 0, 0, 0]) == 2
    assert (pool.arrs["fp_s"][3:] == 0xFFFFFFFF).all()   # fresh EMPTY
    blk = {k: v.copy() for k, v in pool.gather_block(1, 2).items()}
    assert blk["fp_s"].dtype == np.uint32 and blk["w"][1, 0, 0, 0] == 12.0
    pool.drop_prefix(1)                              # global ids survive
    assert (pool.base, pool.n, pool.total) == (1, 2, 3)
    np.testing.assert_array_equal(pool.gather_block(1, 2)["w"], blk["w"])
    idx, mask = pool.gather_ids([2, 1])
    assert idx.tolist() == [1, 0] and mask.all()
    with pytest.raises(ValueError):
        pool.gather_block(0, 1)                      # dropped
    with pytest.raises(ValueError):
        pool.adopt_slabs(pool.slabs, 7)              # past capacity
