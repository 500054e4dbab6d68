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
