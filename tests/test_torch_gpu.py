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


@pytest.mark.parametrize("L,d,b,r,n", [(1, 16, 3, 4, 900),
                                       (64, 16, 3, 4, 652),
                                       (7, 8, 2, 2, 200),
                                       (3, 32, 3, 1, 300)])
def test_leaf_insert_kernel_matches_plain(cuda, L, d, b, r, n):
    rng = np.random.default_rng(L + d + n)
    items = leaf_items(rng, L, n, d, r, 14, cuda)
    before = tli.leaf_insert_batched.launches
    got, got_sp = tli.leaf_insert_batched(tcm.make_nodes(L, d, b, cuda),
                                          *items, r=r)
    assert tli.leaf_insert_batched.launches == before + 1
    want, want_sp = tli.leaf_insert_batched_plain(
        tcm.make_nodes(L, d, b, cuda), *items, r=r)
    torch.cuda.synchronize()
    for name, g, w in zip(tcm.NodeState._fields, got, want):
        assert torch.equal(g, w), name
    assert torch.equal(got_sp, want_sp)
    assert int(got_sp.sum()) > 0 or n < 700
    # K2: the L = 1 launch, continuing in place from a filled matrix
    node = tcm.NodeState(*(x[0].clone() for x in got))
    node_p = tcm.NodeState(*(x[0].clone() for x in got))
    one = [x[0] for x in items]
    _, sp = tli.leaf_insert(node, *one, r=r)
    _, sp_p = tli.leaf_insert_plain(node_p, *one, r=r)
    for name, g, w in zip(tcm.NodeState._fields, node, node_p):
        assert torch.equal(g, w), name
    assert torch.equal(sp, sp_p)


def probe_slabs(rng, cap, d, b, F, dev):
    shape = (cap, d, d, b)
    occ = rng.random(shape) < 0.5
    fp_s = np.where(occ, rng.integers(0, 1 << F, shape), -1)
    fp_d = np.where(occ, rng.integers(0, 1 << F, shape), -1)
    w = np.where(occ, rng.integers(1, 100, shape), 0)
    t = rng.integers(0, 1000, shape)
    t[..., 0] |= 0x80000000                     # unsigned time bounds
    fields = (fp_s.astype(np.int32), fp_d.astype(np.int32),
              w.astype(np.float32), t.astype(np.uint32).view(np.int32),
              np.zeros(shape, np.int32))
    return tcm.NodeState(*(torch.from_numpy(a).to(dev) for a in fields))


@pytest.mark.parametrize("m,d,b,q,r", [(3, 16, 3, 64, 4),
                                       (2, 256, 3, 40, 4),
                                       (5, 32, 2, 16, 2)])
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
