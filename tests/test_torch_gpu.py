"""The port's CUDA kernels against their plain torch versions, on the
card.  Marked ``gpu``: without an NVIDIA GPU every test here skips (the
kernels have no CPU mode; tests/test_torch_kernels.py holds the plain
versions against the JAX reference).  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports neither jax nor the reference package, so it runs
where only torch is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import HiggsParams, HiggsSketch  # noqa: E402
from repro_torch.api.queries import EdgeQuery, VertexQuery  # noqa: E402
from repro_torch.core import cmatrix as tcm  # noqa: E402
from repro_torch.kernels import leaf_insert as tli  # noqa: E402
from repro_torch.kernels import probe as tpr  # noqa: E402
from repro_torch.stream.generator import lkml_like_stream  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode; their plain versions run in the CPU tests)")
    return torch.device("cuda")


def leaf_items(rng, L, n, d, r, F, dev):
    hs = torch.from_numpy(rng.integers(0, 1 << 32, (L, n), dtype=np.uint64)
                          .astype(np.int64))
    hd = torch.from_numpy(rng.integers(0, 1 << 32, (L, n), dtype=np.uint64)
                          .astype(np.int64))
    dup = torch.from_numpy(rng.integers(0, n, n // 4))
    hs[:, dup], hd[:, dup] = hs[:, :1].clone(), hd[:, :1].clone()  # merges
    rows = tcm.chain_from_base((hs >> F) % d, r, d)
    cols = tcm.chain_from_base((hd >> F) % d, r, d)
    t = np.sort(rng.integers(0, 50, (L, n)), axis=1).astype(np.int32)
    items = [hs & ((1 << F) - 1), hd & ((1 << F) - 1), rows, cols,
             torch.from_numpy(rng.integers(1, 9, (L, n)).astype(np.float32)),
             torch.from_numpy(t), torch.from_numpy(rng.random((L, n)) < 0.95)]
    dtypes = [torch.int32] * 4 + [torch.float32, torch.int32, torch.bool]
    return [x.to(dt).contiguous().to(dev) for x, dt in zip(items, dtypes)]


def check_leaf_insert(items, L, d, b, r, nodes=None):
    """K1 on fresh (or the given) matrices against the plain version, then
    K2 continuing in place from the first leaf the kernel filled."""
    dev = items[0].device
    fresh = (lambda: tcm.make_nodes(L, d, b, dev)) if nodes is None \
        else (lambda: tcm.NodeState(*(x.clone() for x in nodes)))
    before = tli.leaf_insert_batched.launches
    got, got_sp = tli.leaf_insert_batched(fresh(), *items, r=r)
    assert tli.leaf_insert_batched.launches == before + 1
    want, want_sp = tli.leaf_insert_batched_plain(fresh(), *items, r=r)
    torch.cuda.synchronize()
    for name, g, w in zip(tcm.NodeState._fields, got, want):
        assert torch.equal(g, w), name
    assert torch.equal(got_sp, want_sp)
    node = tcm.NodeState(*(x[0].clone() for x in got))
    node_p = tcm.NodeState(*(x[0].clone() for x in got))
    one = [x[0] for x in items]
    _, sp = tli.leaf_insert(node, *one, r=r)
    _, sp_p = tli.leaf_insert_plain(node_p, *one, r=r)
    for name, g, w in zip(tcm.NodeState._fields, node, node_p):
        assert torch.equal(g, w), name
    assert torch.equal(sp, sp_p)
    return got, got_sp


@pytest.mark.parametrize("L,d,b,r,n", [(1, 16, 3, 4, 900),
                                       (64, 16, 3, 4, 652),
                                       (7, 8, 2, 2, 200),
                                       (3, 32, 3, 1, 300),
                                       # n not a multiple of the 32-item
                                       # tile, and a single item
                                       (5, 16, 3, 4, 33),
                                       (2, 16, 3, 4, 1),
                                       # b in {2, 3} x r in {1, 2, 4}
                                       (9, 16, 2, 1, 97),
                                       (9, 16, 2, 2, 161),
                                       (9, 16, 2, 4, 400),
                                       (9, 16, 3, 2, 250),
                                       (6, 8, 3, 4, 333),
                                       # the other slot counts it takes
                                       (4, 8, 4, 2, 200),
                                       (3, 8, 8, 1, 120),
                                       # b > 8 or r*r > 32: the kernel
                                       # for any shape
                                       (4, 16, 9, 2, 150),
                                       (3, 16, 3, 6, 200),
                                       (2, 16, 2, 8, 130)])
def test_leaf_insert_kernel_matches_plain(cuda, L, d, b, r, n):
    rng = np.random.default_rng(L + d + n)
    items = leaf_items(rng, L, n, d, r, 14, cuda)
    _, sp = check_leaf_insert(items, L, d, b, r)
    assert int(sp.sum()) > 0 or n < 700


@pytest.mark.parametrize("run", [2, 5, 32])
def test_leaf_insert_kernel_consecutive_identical_items(cuda, run):
    """Runs of identical items: item e+1 hits the slot item e just
    claimed (or merged into), which the kernel patches in registers."""
    L, d, b, r, n = 12, 8, 2, 4, 300
    rng = np.random.default_rng(run)
    items = leaf_items(rng, L, n, d, r, 14, "cpu")
    src = np.arange(n) - np.arange(n) % run        # first item of each run
    items = [x[:, src].contiguous() if i != 6 else x
             for i, x in enumerate(items)]
    got, sp = check_leaf_insert([x.to(cuda) for x in items], L, d, b, r)
    placed = int((items[6].to(cuda) & (sp == 0)).sum())
    assert int((got.fp_s != -1).sum()) < placed    # runs merged


def test_leaf_insert_kernel_all_spill_leaf(cuda):
    """Every slot of every bucket already holds another edge: each item
    spills and the matrices stay as they were."""
    L, d, b, r, n = 4, 16, 3, 4, 200
    rng = np.random.default_rng(7)
    items = leaf_items(rng, L, n, d, r, 14, cuda)
    full = tcm.make_nodes(L, d, b, cuda)
    full.fp_s.fill_(1 << 20)                       # no 14-bit fingerprint
    full.fp_d.fill_(3)
    full.w.fill_(2.5)
    _, sp = check_leaf_insert(items, L, d, b, r, nodes=full)
    assert torch.equal(sp, items[6].to(torch.int32))


def probe_slabs(rng, cap, d, b, F, dev, float_w=False):
    shape = (cap, d, d, b)
    occ = rng.random(shape) < 0.5
    fp_s = np.where(occ, rng.integers(0, 1 << F, shape), -1)
    fp_d = np.where(occ, rng.integers(0, 1 << F, shape), -1)
    w = np.where(occ, rng.exponential(3.0, shape) if float_w
                 else rng.integers(1, 100, shape), 0)
    t = rng.integers(0, 1000, shape)
    t[..., 0] |= 0x80000000                     # unsigned time bounds
    fields = (fp_s.astype(np.int32), fp_d.astype(np.int32),
              w.astype(np.float32), t.astype(np.uint32).view(np.int32),
              np.zeros(shape, np.int32))
    return tcm.NodeState(*(torch.from_numpy(a).to(dev) for a in fields))


@pytest.mark.parametrize("m,d,b,q,r", [(3, 16, 3, 64, 4),
                                       (2, 256, 3, 40, 4),
                                       (5, 32, 2, 16, 2),
                                       # K4 line blocks wider than a probe
                                       # CTA (n_lines*b > 128 slots), at
                                       # one and at eight lines per block
                                       (2, 16, 130, 64, 4),
                                       (2, 1024, 20, 40, 4),
                                       # more than 8 candidates per query
                                       (2, 64, 3, 64, 12)])
@pytest.mark.parametrize("match_time,ts,te", [(False, 0, 0),
                                              (True, 100, 700),
                                              (True, 0x80000000,
                                               0xFFFFFFFF)])
def test_probe_kernels_match_plain(cuda, m, d, b, q, r, match_time, ts, te):
    rng = np.random.default_rng(m * d + q)
    F = 12
    slabs = probe_slabs(rng, m + 3, d, b, F, cuda)
    idx = torch.from_numpy(rng.permutation(m + 3)[:m].astype(np.int32))
    mask = torch.from_numpy(rng.random(m) < 0.8)
    fp_s = slabs.fp_s[idx.long()].cpu().numpy()
    occ = np.argwhere(fp_s != -1)
    pick = occ[rng.integers(0, len(occ), q)]
    fs = fp_s[tuple(pick.T)]
    fd = slabs.fp_d[idx.long()].cpu().numpy()[tuple(pick.T)]
    fs[1::2] = rng.integers(0, 1 << F, len(fs[1::2]))
    rows = np.stack([rng.choice(d, r, replace=False) for _ in range(q)])
    cols = np.stack([rng.choice(d, r, replace=False) for _ in range(q)])
    rows[::2, 0], cols[::2, 0] = pick[::2, 1], pick[::2, 2]
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        idx.numpy(), mask.numpy(), fs.astype(np.int32), fd.astype(np.int32),
        rows.astype(np.int32), cols.astype(np.int32))]
    got = tpr.edge_probe(slabs, *t, ts, te, match_time=match_time)
    want = tpr.edge_probe_plain(slabs, *t, ts, te, match_time=match_time)
    assert torch.equal(got, want)
    assert float(got.sum()) > 0 or match_time
    for direction, fv in (("out", t[2]), ("in", t[3])):
        kw = dict(direction=direction, match_time=match_time)
        got = tpr.vertex_probe(slabs, t[0], t[1], fv, t[4], ts, te, **kw)
        want = tpr.vertex_probe_plain(slabs, t[0], t[1], fv, t[4], ts, te,
                                      **kw)
        assert torch.equal(got, want), direction


def vertex_queries(rng, slabs, idx, direction, lines, r):
    """Per query: the fingerprint of an occupied slot on its line (in a
    random probed matrix), and r distinct candidate lines, that one
    first."""
    fp = (slabs.fp_s if direction == "out" else slabs.fp_d)[idx.long()]
    fp = fp.cpu().numpy()
    d, q = fp.shape[1], len(lines)
    mi = rng.integers(0, len(idx), q)
    fv = np.zeros(q, np.int32)
    for k in range(q):
        line = fp[mi[k], lines[k]] if direction == "out" \
            else fp[mi[k], :, lines[k]]
        occ = line[line != -1]
        if len(occ):
            fv[k] = occ[rng.integers(0, len(occ))]
    step = rng.integers(1, max(d // r, 2), q)
    rows = (lines[:, None] + np.arange(r)[None, :] * step[:, None]) % d
    dev = slabs.fp_s.device
    return (torch.from_numpy(fv).to(dev),
            torch.from_numpy(rows.astype(np.int32)).to(dev))


def check_vertex(rng, slabs, idx, mask, lines, r, ts, te, match_time,
                 float_w=False):
    for direction in ("out", "in"):
        fv, rows = vertex_queries(rng, slabs, idx, direction, lines, r)
        kw = dict(direction=direction, match_time=match_time)
        got = tpr.vertex_probe(slabs, idx, mask, fv, rows, ts, te, **kw)
        want = tpr.vertex_probe_plain(slabs, idx, mask, fv, rows, ts, te,
                                      **kw)
        if float_w:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        else:
            assert torch.equal(got, want), direction
        assert (float(got.sum()) > 0) == bool(mask.any()) or match_time, \
            direction


def probed(rng, cuda, m, d, b, float_w=False):
    slabs = probe_slabs(rng, m + 2, d, b, 12, cuda, float_w)
    idx = torch.from_numpy(rng.permutation(m + 2)[:m].astype(np.int32))
    return slabs, idx.to(cuda)


@pytest.mark.parametrize("same_vertex", [True, False])
def test_vertex_probe_kernel_all_queries_on_one_line(cuda, same_vertex):
    """d = 1024, "out" and "in": every query's first candidate is the same
    line (one hot line block split over many work units), as one vertex
    or as many vertices whose first lines coincide."""
    rng = np.random.default_rng(11 + same_vertex)
    m, d, b, q, r = 2, 1024, 3, 1500, 4
    slabs, idx = probed(rng, cuda, m, d, b)
    lines = np.full(q, 517)
    mask = torch.ones(m, dtype=torch.bool, device=cuda)
    if same_vertex:
        for direction in ("out", "in"):
            fv, rows = vertex_queries(rng, slabs, idx, direction, lines[:1],
                                      r)
            fv, rows = fv.expand(q).contiguous(), rows.expand(q, r).clone()
            kw = dict(direction=direction, match_time=False)
            got = tpr.vertex_probe(slabs, idx, mask, fv, rows, 0, 0, **kw)
            want = tpr.vertex_probe_plain(slabs, idx, mask, fv, rows, 0, 0,
                                          **kw)
            assert torch.equal(got, want), direction
            assert float(got.min()) > 0 and bool((got == got[0]).all())
    else:
        check_vertex(rng, slabs, idx, mask, lines, r, 0, 0, False)


@pytest.mark.parametrize("m,mask_bits", [(1, (1,)), (1, (0,)),
                                         (4, (1, 0, 0, 1))])
def test_vertex_probe_kernel_masked_matrices(cuda, m, mask_bits):
    rng = np.random.default_rng(m * 10 + sum(mask_bits))
    d, b, q, r = 64, 3, 300, 4
    slabs, idx = probed(rng, cuda, m, d, b)
    mask = torch.tensor(mask_bits, dtype=torch.bool, device=cuda)
    check_vertex(rng, slabs, idx, mask, rng.integers(0, d, q), r, 0, 0,
                 False)


def test_vertex_probe_kernel_many_queries(cuda):
    """More (query, candidate) pairs than one launch of the three kernels
    takes (16,384): the wrapper's queries go through in chunks."""
    rng = np.random.default_rng(5)
    m, d, b, q, r = 3, 64, 3, 9000, 4
    slabs, idx = probed(rng, cuda, m, d, b)
    mask = torch.ones(m, dtype=torch.bool, device=cuda)
    check_vertex(rng, slabs, idx, mask, rng.integers(0, d, q), r, 0, 0,
                 False)


@pytest.mark.parametrize("d", [16, 256, 1024])
def test_vertex_probe_kernel_time_filter_float_weights(cuda, d):
    """Non-integer weights: the kernel sums in another order than the
    plain version, so rtol 1e-6 (as tests/test_kernels.py holds the
    reference)."""
    rng = np.random.default_rng(d)
    m, b, q, r = 3, 3, 2048, 4
    slabs, idx = probed(rng, cuda, m, d, b, float_w=True)
    mask = torch.ones(m, dtype=torch.bool, device=cuda)
    lines = rng.integers(0, d, q)
    for ts, te in ((100, 700), (0, 0xFFFFFFFF)):
        check_vertex(rng, slabs, idx, mask, lines, r, ts, te, True,
                     float_w=True)


def level_case(rng, dev, kw, plan, q, float_w=False, m_range=(1, 5),
               min_m=1):
    """K3 entries over random level slabs (``plan``: (level, match_time)
    per entry; one slab set per level, of m_range[0] + 2 or more rows),
    half the queries planted on a candidate bucket of each entry, and the
    leaf-level query side."""
    p = HiggsParams(**kw)
    r = p.r if p.use_mmb else 1

    def draw(lo, hi, n):
        return torch.from_numpy(rng.integers(lo, hi, n, dtype=np.uint64)
                                .astype(np.int64))

    f1s, f1d = draw(0, 1 << p.F1, q), draw(0, 1 << p.F1, q)
    rows1 = tcm.chain_from_base(draw(0, p.d1, q), r, p.d1)
    cols1 = tcm.chain_from_base(draw(0, p.d1, q), r, p.d1)
    slabs, caps = {}, {}
    for level in sorted({lv for lv, _ in plan}):
        caps[level] = int(rng.integers(*m_range)) + 2
        slabs[level] = probe_slabs(rng, caps[level], p.d(level), p.b,
                                   p.F(level), "cpu", float_w)
    entries = []
    for level, match_time in plan:
        cap = caps[level]
        m = int(rng.integers(min(min_m, cap), cap + 1))
        idx = rng.permutation(cap)[:m].astype(np.int32)
        mask = rng.random(m) < 0.75
        mask[0] = True
        fs, rows = tcm.level_coords(f1s, rows1, level, p)
        fd, cols = tcm.level_coords(f1d, cols1, level, p)
        live, sl = idx[mask], slabs[level]
        for i in range(0, q, 2):
            c = (int(live[rng.integers(0, len(live))]),
                 int(rows[i, rng.integers(0, r)]),
                 int(cols[i, rng.integers(0, r)]), int(rng.integers(0, p.b)))
            sl.fp_s[c], sl.fp_d[c] = int(fs[i]), int(fd[i])
            sl.w[c] = float(rng.integers(1, 100))
            sl.t[c] = int(rng.integers(100, 701))
        entries.append((level, idx, mask, match_time))
    dslabs = {lv: tcm.NodeState(*(f.to(dev) for f in sl))
              for lv, sl in slabs.items()}
    entries = [tpr.EdgeEntry(dslabs[lv], idx, mask, lv, 100, 700, mt)
               for lv, idx, mask, mt in entries]
    i32 = torch.int32
    leaf = [x.to(i32).to(dev) for x in (f1s, rows1, f1d, cols1)]
    return p, entries, leaf


def check_levels(p, entries, leaf, float_w=False):
    before = tpr.edge_probe.launches
    got = tpr.edge_probe_levels(entries, *leaf, params=p)
    n, q = len(entries), leaf[0].shape[0]
    assert tpr.edge_probe.launches == before + (-(-n // tpr.MAX_ENTRIES)
                                                if n and q else 0)
    want = tpr.edge_probe_levels_plain(entries, *leaf, params=p)
    assert got.shape == want.shape == (n, q)
    if float_w:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        assert torch.equal(got, want)
    return got


def levels(n, filtered=True):
    return [(lv, False) for lv in range(1, n + 1)] + \
        ([(1, True)] if filtered else [])


@pytest.mark.parametrize("plan,kw,q", [
    (levels(7), dict(d1=2, F1=12, b=3, r=2), 300),
    (levels(3), dict(d1=4, F1=12, b=1, r=2, use_mmb=False), 64),
    (levels(2), dict(d1=4, F1=12, b=9, r=4), 64),          # any-shape kernel
    (levels(5), dict(d1=2, F1=5, b=3, r=2), 100),          # F = 1 at level 5
    (levels(3), dict(d1=4, F1=13, b=2, r=3, theta=16), 77),
    (levels(2), dict(d1=8, F1=14, b=4, r=4), 33),
    (levels(2), dict(d1=64, F1=14, b=1, r=40), 50),        # r > 32
    (levels(4), dict(d1=128, F1=14, b=3, r=4), 1000),      # d = 1024
    (levels(2), dict(d1=16, F1=19, b=3, r=4), 1),
    (levels(2), dict(d1=16, F1=19, b=3, r=4), 0),
    # a full descriptor list, and one past it (two launches)
    ([(1 + k % 5, k % 3 == 0) for k in range(16)],
     dict(d1=4, F1=12, b=3, r=4), 96),
    ([(1 + k % 5, k % 3 == 0) for k in range(19)],
     dict(d1=4, F1=12, b=3, r=4), 96),
])
def test_edge_probe_levels_kernel_matches_plain(cuda, plan, kw, q):
    rng = np.random.default_rng(len(plan) * 1000 + q)
    p, entries, leaf = level_case(rng, cuda, kw, plan, q)
    got = check_levels(p, entries, leaf)
    if q > 1:
        assert bool((got[:, ::2] > 0).any(dim=1).all())      # planted hits


@pytest.mark.parametrize("kw", [dict(d1=8, F1=14, b=3, r=4),
                                dict(d1=4, F1=12, b=5, r=3)])
def test_edge_probe_levels_kernel_float_weights(cuda, kw):
    rng = np.random.default_rng(kw["b"])
    p, entries, leaf = level_case(rng, cuda, kw, levels(3), 200,
                                  float_w=True)
    check_levels(p, entries, leaf, float_w=True)


def test_edge_probe_levels_kernel_many_matrices(cuda):
    """More matrices in one entry than a warp's lanes hold (32 per pass),
    many passes."""
    rng = np.random.default_rng(600)
    for kw in (dict(d1=4, F1=12, b=3, r=4), dict(d1=4, F1=12, b=6, r=3)):
        p, entries, leaf = level_case(rng, cuda, kw, levels(1), 64,
                                      m_range=(600, 601), min_m=550)
        assert min(len(e.idx) for e in entries) > 16 * 32
        check_levels(p, entries, leaf)


@pytest.mark.parametrize("d,b", [(16, 769), (16, 1024), (256, 769)])
@pytest.mark.parametrize("match_time,ts,te", [(False, 0, 0),
                                              (True, 100, 700)])
def test_vertex_probe_kernel_wide_buckets(cuda, d, b, match_time, ts, te):
    """b > 768: a cross position's slots are staged in chunks."""
    rng = np.random.default_rng(d + b)
    m = 2 if d < 256 else 1                 # d = 256: two lines per block
    slabs = probe_slabs(rng, m, d, b, 12, cuda)
    idx = torch.arange(m, dtype=torch.int32, device=cuda)
    mask = torch.ones(m, dtype=torch.bool, device=cuda)
    check_vertex(rng, slabs, idx, mask, rng.integers(0, d, 300), 4, ts, te,
                 match_time)


def test_sketch_wide_buckets_answer_queries(cuda):
    """A sketch with b = 1024 ingests and answers vertex and edge queries
    on the card as the plain versions do; an edge batch is one K3
    launch."""
    stream = lkml_like_stream(20_000, seed=5)
    p = HiggsParams(d1=2, F1=14, b=1024, r=2)
    sks = [HiggsSketch(p, device=cuda, kernels=k) for k in (True, False)]
    for sk in sks:
        sk.insert(*stream)
        sk.flush()
    assert sks[0].n_levels >= 2
    t0, t1 = int(stream[3][0]), int(stream[3][-1])
    qs = [VertexQuery(stream[0][:200], t0, t1, "out"),
          VertexQuery(stream[1][:200], t0, (t0 + t1) // 2, "in"),
          EdgeQuery(stream[0][:300], stream[1][:300], t0, t1)]
    v0, e0 = tpr.vertex_probe.launches, tpr.edge_probe.launches
    got = sks[0].query(qs).values
    assert tpr.vertex_probe.launches > v0 and tpr.edge_probe.launches == e0 + 1
    for x, y in zip(got, sks[1].query(qs).values):
        np.testing.assert_array_equal(x, y)
    assert (np.asarray(got[0]) > 0).all()


def test_sketch_rejects_more_candidates_than_the_vertex_kernel_takes(cuda):
    with pytest.raises(ValueError, match="vertex-probe kernel"):
        HiggsSketch(HiggsParams(r=tpr.VERTEX_MAX_R + 1), device=cuda)


def test_sketch_kernels_match_plain_end_to_end(cuda):
    stream = lkml_like_stream(20_000, seed=3)
    sks = [HiggsSketch(HiggsParams(), device=cuda, kernels=k)
           for k in (True, False)]
    for sk in sks:
        for lo in range(0, 20_000, 6000):
            sk.insert(*(a[lo:lo + 6000] for a in stream))
        sk.flush()
    a, b = sks
    assert [p.n for p in a.pools] == [p.n for p in b.pools]
    for pa, pb in zip(a.pools, b.pools):
        for name in tcm.NodeState._fields:
            np.testing.assert_array_equal(pa.arrs[name][:pa.n],
                                          pb.arrs[name][:pb.n])
    assert list(a.ob.data) == list(b.ob.data)
    t0, t1 = int(stream[3][0]), int(stream[3][-1])
    qs = []
    for ts, te in ((t0, t1), (t0 + (t1 - t0) // 3, t0 + (t1 - t0) // 2)):
        qs += [EdgeQuery(stream[0][:200], stream[1][:200], ts, te),
               VertexQuery(stream[0][:100], ts, te, "out"),
               VertexQuery(stream[1][:100], ts, te, "in")]
    before = tpr.edge_probe.launches
    for x, y in zip(a.query(qs).values, b.query(qs).values):
        np.testing.assert_array_equal(x, y)
    assert tpr.edge_probe.launches > before


@pytest.mark.parametrize("L,d,b,r,n", [(3, 64, 3, 4, 700),
                                       (2, 32, 12, 4, 500),
                                       (2, 4, 3000, 4, 300)])
def test_leaf_insert_kernel_large_leaves(cuda, L, d, b, r, n):
    """Leaves whose matrices exceed a block's shared memory (d*d*b*20
    bytes over about 227 KB) take the global-memory form: bit-exact
    against the plain version, K1 and K2 alike."""
    rng = np.random.default_rng(L + d + b)
    items = leaf_items(rng, L, n, d, r, 14, cuda)
    g1, g2 = tli.leaf_insert_batched.global_launches, \
        tli.leaf_insert.global_launches
    check_leaf_insert(items, L, d, b, r)
    assert tli.leaf_insert_batched.global_launches == g1 + 1
    assert tli.leaf_insert.global_launches == g2 + 1


def test_leaf_insert_kernel_large_leaf_all_spill(cuda):
    L, d, b, r, n = 2, 32, 12, 2, 200
    rng = np.random.default_rng(8)
    items = leaf_items(rng, L, n, d, r, 14, cuda)
    full = tcm.make_nodes(L, d, b, cuda)
    full.fp_s.fill_(1 << 20)                       # no 14-bit fingerprint
    full.w.fill_(1.5)
    _, sp = check_leaf_insert(items, L, d, b, r, nodes=full)
    assert torch.equal(sp, items[6].to(torch.int32))


def assert_twins_equal(a, b):
    """Pools (with their bases), leaf index and overflow store of two
    sketches equal bit for bit."""
    assert [(p.n, p.base) for p in a.pools] == \
        [(p.n, p.base) for p in b.pools]
    for pa, pb in zip(a.pools, b.pools):
        for name in tcm.NodeState._fields:
            np.testing.assert_array_equal(pa.arrs[name][:pa.n],
                                          pb.arrs[name][:pb.n])
    np.testing.assert_array_equal(a.leaf_ends, b.leaf_ends)
    da, db = a.ob.data, b.ob.data
    assert list(da) == list(db)
    for key in da:
        for f in da[key]:
            np.testing.assert_array_equal(da[key][f], db[key][f])
    assert a.segments.meta() == b.segments.meta()


def twin_queries(stream):
    t0, t1 = int(stream[3][0]), int(stream[3][-1])
    qs = []
    for ts, te in ((t0, t1), (t0 + (t1 - t0) // 3, t0 + (t1 - t0) // 2),
                   (t1 - (t1 - t0) // 20, t1)):
        qs += [EdgeQuery(stream[0][-300:], stream[1][-300:], ts, te),
               VertexQuery(stream[0][-150:], ts, te, "out"),
               VertexQuery(stream[1][-150:], ts, te, "in")]
    return qs


def test_sketch_large_leaves_match_plain(cuda):
    """A d1 = 64 sketch (10,444-item leaves, 240 KB of slots each) ingests
    through K1's global-memory form as its plain twin does."""
    stream = lkml_like_stream(30_000, seed=6)
    p = HiggsParams(d1=64, b=3)
    g0 = tli.leaf_insert_batched.global_launches
    sks = [HiggsSketch(p, device=cuda, kernels=k) for k in (True, False)]
    for sk in sks:
        for lo in range(0, 30_000, 12_000):
            sk.insert(*(a[lo:lo + 12_000] for a in stream))
        sk.flush()
    assert tli.leaf_insert_batched.global_launches > g0
    assert_twins_equal(*sks)
    qs = twin_queries(stream)
    for x, y in zip(sks[0].query(qs).values, sks[1].query(qs).values):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("retention", ["window", "budget"])
def test_retention_sketch_matches_plain(cuda, retention):
    """Windowed and budgeted sketches on the card equal their
    ``kernels=False`` twins (pools, bases, overflow store, segments,
    answers), with K1, K3 and K4 launched."""
    stream = lkml_like_stream(40_000, seed=3)
    span = int(stream[3][-1]) - int(stream[3][0])
    pol = f"window:{span // 4}" if retention == "window" \
        else "budget:1500000"
    sks = [HiggsSketch(HiggsParams(retention=pol), device=cuda, kernels=k)
           for k in (True, False)]
    k1 = tli.leaf_insert_batched.launches
    for sk in sks:
        for lo in range(0, 40_000, 7_000):
            sk.insert(*(a[lo:lo + 7_000] for a in stream))
        sk.flush()
    assert tli.leaf_insert_batched.launches > k1
    st = sks[0].retention_stats()
    assert st["segments_evicted"] + st["segments_coarse"] > 0, st
    if retention == "budget":
        assert st["segments_coarse"] > 0
        assert sks[0].space_bytes() <= 1_500_000
    assert_twins_equal(*sks)
    qs = twin_queries(stream)
    e0, v0 = tpr.edge_probe.launches, tpr.vertex_probe.launches
    for x, y in zip(sks[0].query(qs).values, sks[1].query(qs).values):
        np.testing.assert_array_equal(x, y)
    assert tpr.edge_probe.launches > e0 and tpr.vertex_probe.launches > v0


def test_snapshot_on_card_restores_on_cpu(cuda, tmp_path):
    stream = lkml_like_stream(20_000, seed=4)
    span = int(stream[3][-1]) - int(stream[3][0])
    sk = HiggsSketch(HiggsParams(retention=f"window:{span // 5}"),
                     device=cuda)
    sk.insert(*(a[:17_000] for a in stream))      # a partial leaf pending
    sk.save(str(tmp_path), 17_000)
    cpu = HiggsSketch(HiggsParams(), device="cpu")
    cpu.restore(str(tmp_path))
    assert cpu.device.type == "cpu" and cpu.segments.n_evicted > 0
    (xa, ma), (xb, mb) = sk.state_dict(), cpu.state_dict()
    assert ma == mb and sorted(xa) == sorted(xb)
    for k in xa:
        np.testing.assert_array_equal(xa[k], xb[k], err_msg=k)
    qs = twin_queries(stream)
    for x, y in zip(sk.query(qs).values, cpu.query(qs).values):
        np.testing.assert_array_equal(x, y)
