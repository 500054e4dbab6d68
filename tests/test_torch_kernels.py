"""Port kernels against the JAX reference: the plain torch versions of
K1/K2 (leaf insert) and K3/K4 (probes) against the Pallas kernels in
interpret mode and the numpy/jnp oracles, plus the aggregation placement
engine against the reference's host twin.  Pools and spill masks match
bit for bit; probe sums exactly on integer weights and to rtol 1e-6 on
float weights, as in tests/test_kernels.py.

The CUDA kernels themselves run only on a card: tests/test_torch_gpu.py
holds them against these plain versions there.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cmatrix as rcm  # noqa: E402
from repro.core.cmatrix import EMPTY as REF_EMPTY  # noqa: E402
from repro.core.cmatrix import NodeState as RefNodes  # noqa: E402
from repro.core.params import HiggsParams as RefParams  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.leaf_insert import (leaf_insert_batched_pallas,  # noqa: E402
                                       leaf_insert_pallas)
from repro.kernels.probe import (edge_probe_pallas,  # noqa: E402
                                 vertex_probe_pallas)
from repro_torch.core import cmatrix as tcm  # noqa: E402
from repro_torch.core.cmatrix import NodeState  # noqa: E402
from repro_torch.core.params import HiggsParams  # noqa: E402
from repro_torch.kernels import leaf_insert as tli  # noqa: E402
from repro_torch.kernels import probe as tpr  # noqa: E402
from repro_torch.kernels.ref import seq_insert_ref  # noqa: E402

FIELDS = RefNodes._fields

# jitted reference probes: the integer- and float-weight cases of one
# shape share a trace
_edge_pallas = jax.jit(functools.partial(edge_probe_pallas, interpret=True),
                       static_argnames=("match_time",))
_vertex_pallas = jax.jit(functools.partial(vertex_probe_pallas,
                                           interpret=True),
                         static_argnames=("direction", "match_time"))
_edge_jnp = jax.jit(rcm.probe_edge, static_argnames=("match_time",))
_vertex_jnp = jax.jit(rcm.probe_vertex,
                      static_argnames=("direction", "match_time"))


def to_torch(arrs, device="cpu") -> NodeState:
    """NodeState tensors from reference-dtype numpy fields."""
    return NodeState(*(torch.from_numpy(np.ascontiguousarray(
        np.asarray(arrs[i]).view(np.float32 if f == "w" else np.int32)))
        .to(device) for i, f in enumerate(FIELDS)))


def as_ref(nodes):
    """Reference-dtype numpy fields of port (or reference) nodes."""
    out = []
    for f, x in zip(FIELDS, nodes):
        a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        out.append(a if f == "w" else a.view(np.uint32))
    return out


def insert_inputs(rng, shape, d, r, F, t_max=50, dup=True):
    """Hashed items for leaf insertion (the sweep of test_kernels.py)."""
    n = shape[-1]
    hs = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    hd = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    if dup:   # duplicate some items to exercise the merge path
        idx = rng.integers(0, n, n // 4)
        hs[..., idx] = hs[..., :1]
        hd[..., idx] = hd[..., :1]
    w = rng.integers(1, 9, shape).astype(np.float32)
    t = np.sort(rng.integers(0, t_max, shape).astype(np.uint32), axis=-1)
    valid = rng.random(shape) < 0.95
    fs = hs & np.uint32((1 << F) - 1)
    fd = hd & np.uint32((1 << F) - 1)
    rows = np.asarray(rcm.chain_from_base((hs >> F) % d, r, d))
    cols = np.asarray(rcm.chain_from_base((hd >> F) % d, r, d))
    return fs, fd, rows, cols, w, t, valid


def torch_items(fs, fd, rows, cols, w, t, valid, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        fs.view(np.int32), fd.view(np.int32), rows.astype(np.int32),
        cols.astype(np.int32), w, t.view(np.int32), valid)]


# ---------------------------------------------------------------------------
# K2 (one leaf) and K1 (L leaves): plain torch vs Pallas vs Alg.-1 oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,b,r,n", [
    (8, 2, 2, 50),
    (16, 3, 4, 400),
    (16, 3, 4, 900),     # oversubscribed -> spills
    (32, 3, 1, 200),     # MMB disabled
])
def test_leaf_insert_plain_bit_exact(d, b, r, n):
    rng = np.random.default_rng(d + n)
    items = insert_inputs(rng, (n,), d, r, F=14)
    fs, fd, rows, cols, w, t, valid = items
    node0 = rcm.make_node(d, b)
    want_p, want_sp = leaf_insert_pallas(
        node0, *(jnp.asarray(a) for a in items), r=r, interpret=True)
    want_o, want_so = rref.seq_insert_ref(rcm.make_node(d, b), *items, b=b,
                                          r=r)
    port_o, port_so = seq_insert_ref(rcm.make_node(d, b), *items, b=b, r=r)
    np.testing.assert_array_equal(port_so, want_so)   # the port's oracle copy
    for name, a, c in zip(FIELDS, as_ref(port_o), as_ref(want_o)):
        np.testing.assert_array_equal(a, c, err_msg=name)
    node = tcm.make_nodes(1, d, b, "cpu")
    node = NodeState(*(x[0] for x in node))
    got, got_sp = tli.leaf_insert(node, *torch_items(*items), r=r)
    assert tli.leaf_insert.launches == 0          # CPU: plain version
    for name, g, wp, wo in zip(FIELDS, as_ref(got), as_ref(want_p),
                               as_ref(want_o)):
        np.testing.assert_array_equal(g, wp, err_msg=name)
        np.testing.assert_array_equal(g, wo, err_msg=name)
    np.testing.assert_array_equal(got_sp.numpy(), np.asarray(want_sp))
    np.testing.assert_array_equal(got_sp.numpy().astype(bool), want_so)


@pytest.mark.parametrize("L,d,b,r,n", [
    (1, 8, 2, 2, 40),
    (3, 8, 2, 2, 64),
    (4, 16, 3, 4, 128),
    (5, 4, 2, 2, 96),    # tiny leaves: most items spill
    (2, 16, 9, 2, 80),   # b > 8 and r*r > 32: the CUDA kernel for any
    (2, 16, 3, 6, 80),   # shape serves these
])
def test_leaf_insert_batched_plain_bit_exact(L, d, b, r, n):
    rng = np.random.default_rng(L * 100 + d)
    items = insert_inputs(rng, (L, n), d, r, F=12, dup=False)
    nodes0 = rcm.make_nodes(L, d, b)
    want, want_sp = leaf_insert_batched_pallas(
        nodes0, *(jnp.asarray(a) for a in items), r=r, interpret=True)
    got, got_sp = tli.leaf_insert_batched(tcm.make_nodes(L, d, b, "cpu"),
                                          *torch_items(*items), r=r)
    for name, g, wv in zip(FIELDS, as_ref(got), as_ref(want)):
        np.testing.assert_array_equal(g, wv, err_msg=name)
    np.testing.assert_array_equal(got_sp.numpy(), np.asarray(want_sp))
    for l in range(L):                                    # Alg.-1 oracle
        node_o, sp_o = rref.seq_insert_ref(rcm.make_node(d, b),
                                           *(a[l] for a in items), b=b, r=r)
        for name, g, wo in zip(FIELDS, as_ref(got), as_ref(node_o)):
            np.testing.assert_array_equal(g[l], wo, err_msg=f"{l}/{name}")
        np.testing.assert_array_equal(got_sp.numpy()[l].astype(bool), sp_o)


@pytest.mark.parametrize("L,d,b,r,n,run", [
    (3, 8, 2, 2, 64, 4),
    (2, 16, 3, 4, 96, 32),
    (4, 4, 2, 2, 50, 3),     # tiny leaves: runs that spill
])
def test_leaf_insert_batched_plain_runs_of_identical_items(L, d, b, r, n,
                                                           run):
    """Leaves of repeated identical items: each item of a run merges into
    the slot the run's first item claimed (or spills with it)."""
    rng = np.random.default_rng(L * 10 + run)
    items = list(insert_inputs(rng, (L, n), d, r, F=12, dup=False))
    first = np.arange(n) - np.arange(n) % run
    for i in (0, 1, 4, 5):                         # fs, fd, w, t
        items[i] = np.ascontiguousarray(items[i][:, first])
    for i in (2, 3):                               # rows, cols
        items[i] = np.ascontiguousarray(items[i][:, first])
    want, want_sp = leaf_insert_batched_pallas(
        rcm.make_nodes(L, d, b), *(jnp.asarray(a) for a in items), r=r,
        interpret=True)
    got, got_sp = tli.leaf_insert_batched(tcm.make_nodes(L, d, b, "cpu"),
                                          *torch_items(*items), r=r)
    for name, g, wv in zip(FIELDS, as_ref(got), as_ref(want)):
        np.testing.assert_array_equal(g, wv, err_msg=name)
    np.testing.assert_array_equal(got_sp.numpy(), np.asarray(want_sp))
    for l in range(L):                                    # Alg.-1 oracle
        node_o, sp_o = rref.seq_insert_ref(rcm.make_node(d, b),
                                           *(a[l] for a in items), b=b, r=r)
        for name, g, wo in zip(FIELDS, as_ref(got), as_ref(node_o)):
            np.testing.assert_array_equal(g[l], wo, err_msg=f"{l}/{name}")
        np.testing.assert_array_equal(got_sp.numpy()[l].astype(bool), sp_o)
    placed = items[6] & ~got_sp.numpy().astype(bool)
    assert int((as_ref(got)[0] != np.uint32(REF_EMPTY)).sum()) \
        < int(placed.sum())                            # runs merged


def test_leaf_insert_updates_in_place_from_a_filled_node():
    """The kernels alias their matrices: a second call continues from the
    state the first left (the reference's input/output aliasing)."""
    rng = np.random.default_rng(5)
    d, b, r, n = 8, 2, 2, 60
    items = insert_inputs(rng, (2, n), d, r, F=12)
    node = tcm.make_nodes(1, d, b, "cpu")
    node = NodeState(*(x[0] for x in node))
    ref = rcm.make_node(d, b)
    for half in range(2):
        part = [a[half] for a in items]
        tli.leaf_insert(node, *torch_items(*part), r=r)
        ref, _ = rref.seq_insert_ref(ref, *part, b=b, r=r)
    for name, g, wo in zip(FIELDS, as_ref(node), as_ref(ref)):
        np.testing.assert_array_equal(g, wo, err_msg=name)


# ---------------------------------------------------------------------------
# K3 / K4: plain torch probes vs Pallas (interpret) and cmatrix.probe_*
# ---------------------------------------------------------------------------

def random_slabs(rng, cap, d, b, F, t_max=1000, fill=0.5, float_w=False):
    shape = (cap, d, d, b)
    occupied = rng.random(shape) < fill
    fp_s = np.where(occupied, rng.integers(0, 1 << F, shape), REF_EMPTY)
    fp_d = np.where(occupied, rng.integers(0, 1 << F, shape), REF_EMPTY)
    w = rng.exponential(3.0, shape) if float_w \
        else rng.integers(1, 100, shape)
    w = np.where(occupied, w, 0).astype(np.float32)
    t = rng.integers(0, t_max, shape).astype(np.uint32)
    idx = rng.integers(0, 4, shape).astype(np.uint32)
    return [fp_s.astype(np.uint32), fp_d.astype(np.uint32), w, t, idx]


def probe_setup(rng, m, d, b, q, r, F, float_w):
    cap = m + 3
    arrs = random_slabs(rng, cap, d, b, F, float_w=float_w)
    rows_ix = rng.permutation(cap)[:m].astype(np.int32)   # gathered rows
    nodes = RefNodes(*(jnp.asarray(a[rows_ix]) for a in arrs))
    mask = rng.random(m) < 0.8
    mask[0] = True
    # half the queries planted on occupied entries of probed matrices
    fs = rng.integers(0, 1 << F, q).astype(np.uint32)
    fd = rng.integers(0, 1 << F, q).astype(np.uint32)
    occ = np.argwhere(arrs[0][rows_ix] != REF_EMPTY)
    for i in range(0, q, 2):
        mi, r_, c_, s_ = occ[rng.integers(0, len(occ))]
        fs[i] = arrs[0][rows_ix][mi, r_, c_, s_]
        fd[i] = arrs[1][rows_ix][mi, r_, c_, s_]
    rows = np.stack([rng.choice(d, r, replace=False) for _ in range(q)]
                    ).astype(np.int32)
    cols = np.stack([rng.choice(d, r, replace=False) for _ in range(q)]
                    ).astype(np.int32)
    return arrs, rows_ix, nodes, mask, fs, fd, rows, cols


def check_probe(got, want, float_w):
    if float_w:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,d,b,q,r", [
    (1, 8, 2, 4, 1),
    (3, 16, 3, 16, 4),
    (5, 32, 3, 8, 2),
    (2, 64, 4, 32, 4),
])
@pytest.mark.parametrize("match_time", [False, True])
@pytest.mark.parametrize("float_w", [False, True])
def test_edge_probe_plain(m, d, b, q, r, match_time, float_w):
    rng = np.random.default_rng(d * 1000 + q + int(match_time))
    F = 12
    arrs, rows_ix, nodes, mask, fs, fd, rows, cols = probe_setup(
        rng, m, d, b, q, r, F, float_w)
    ts, te = 100, 700
    args = (jnp.asarray(mask), jnp.asarray(fs), jnp.asarray(fd),
            jnp.asarray(rows), jnp.asarray(cols))
    want_p = np.asarray(_edge_pallas(nodes, *args, np.uint32(ts),
                                     np.uint32(te), match_time=match_time))
    want_j = np.asarray(_edge_jnp(nodes, *args, np.uint32(ts),
                                  np.uint32(te), match_time=match_time))
    got = tpr.edge_probe(
        to_torch(arrs), torch.from_numpy(rows_ix), torch.from_numpy(mask),
        torch.from_numpy(fs.view(np.int32)),
        torch.from_numpy(fd.view(np.int32)), torch.from_numpy(rows),
        torch.from_numpy(cols), ts, te, match_time=match_time).numpy()
    assert tpr.edge_probe.launches == 0
    check_probe(got, want_p, float_w)
    check_probe(got, want_j, float_w)


@pytest.mark.parametrize("m,d,b,q,r", [
    (1, 8, 2, 4, 2),
    (3, 16, 3, 16, 4),
    (2, 32, 4, 8, 4),
    (2, 64, 3, 8, 12),   # more than 8 candidates per query
])
@pytest.mark.parametrize("direction", ["out", "in"])
@pytest.mark.parametrize("match_time", [False, True])
@pytest.mark.parametrize("float_w", [False, True])
def test_vertex_probe_plain(m, d, b, q, r, direction, match_time, float_w):
    rng = np.random.default_rng(d * 77 + q + int(match_time))
    F = 10
    arrs, rows_ix, nodes, mask, fs, fd, rows, _ = probe_setup(
        rng, m, d, b, q, r, F, float_w)
    fv = fs if direction == "out" else fd
    ts, te = 200, 800
    args = (jnp.asarray(mask), jnp.asarray(fv), jnp.asarray(rows))
    want_p = np.asarray(_vertex_pallas(
        nodes, *args, np.uint32(ts), np.uint32(te), direction=direction,
        match_time=match_time))
    want_j = np.asarray(_vertex_jnp(
        nodes, *args, np.uint32(ts), np.uint32(te), direction=direction,
        match_time=match_time))
    got = tpr.vertex_probe(
        to_torch(arrs), torch.from_numpy(rows_ix), torch.from_numpy(mask),
        torch.from_numpy(fv.view(np.int32)), torch.from_numpy(rows), ts, te,
        direction=direction, match_time=match_time).numpy()
    assert tpr.vertex_probe.launches == 0
    check_probe(got, want_p, float_w)
    check_probe(got, want_j, float_w)


@pytest.mark.parametrize("direction", ["out", "in"])
@pytest.mark.parametrize("match_time", [False, True])
def test_vertex_probe_plain_many_queries_few_vertices(direction,
                                                     match_time):
    """Many queries on few vertices (the Zipf-drawn query sets, whose
    candidate lines the kernel groups): 96 queries on 3 vertices."""
    rng = np.random.default_rng(40 + int(match_time))
    m, d, b, q, r, F = 3, 32, 3, 96, 4, 10
    arrs, rows_ix, nodes, mask, fs, fd, rows, _ = probe_setup(
        rng, m, d, b, q, r, F, False)
    # three vertices, each planted on an occupied slot of matrix 0 (its
    # line first among its candidates), then drawn for all q queries
    occ = np.argwhere(arrs[0][rows_ix[0]] != REF_EMPTY)
    hot = occ[rng.choice(len(occ), 3, replace=False)]
    side = 0 if direction == "out" else 1
    fv3 = arrs[side][rows_ix[0]][tuple(hot.T)]
    line = hot[:, side]
    rows3 = (line[:, None] + np.arange(r)[None, :] * 5) % d
    pick = rng.integers(0, 3, q)
    fv = fv3[pick]
    rows = np.ascontiguousarray(rows3[pick].astype(np.int32))
    ts, te = 200, 800
    args = (jnp.asarray(mask), jnp.asarray(fv), jnp.asarray(rows))
    want_p = np.asarray(_vertex_pallas(
        nodes, *args, np.uint32(ts), np.uint32(te), direction=direction,
        match_time=match_time))
    want_j = np.asarray(_vertex_jnp(
        nodes, *args, np.uint32(ts), np.uint32(te), direction=direction,
        match_time=match_time))
    got = tpr.vertex_probe(
        to_torch(arrs), torch.from_numpy(rows_ix), torch.from_numpy(mask),
        torch.from_numpy(fv.view(np.int32)), torch.from_numpy(rows), ts, te,
        direction=direction, match_time=match_time).numpy()
    np.testing.assert_array_equal(got, want_p)
    np.testing.assert_array_equal(got, want_j)
    assert len(np.unique(got)) <= 3 and (got.max() > 0 or match_time)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256, 512, 1024])
def test_vertex_candidates_are_distinct(d):
    """The r candidate lines of every vertex are distinct at every level
    width (the LCG chain is full-period mod d = 2^k), so a line-grouped
    probe counts each candidate line of a query once, as the reference's
    one-hot form does; the port's chains equal the reference's."""
    x0 = np.arange(d, dtype=np.uint32)
    for r in (2, 4, 5):
        want = np.asarray(rcm.chain_from_base(jnp.asarray(x0), r, d))
        got = tcm.chain_from_base(torch.from_numpy(x0.astype(np.int64)), r,
                                  d).numpy()
        np.testing.assert_array_equal(got, want)
        srt = np.sort(got, axis=1)
        assert (srt[:, 1:] != srt[:, :-1]).all(), (d, r)


def test_probe_time_bounds_compare_unsigned():
    """Timestamps at or above 2**31 are large unsigned values, never
    negative ones (slab fields are int32 bit patterns)."""
    rng = np.random.default_rng(3)
    arrs = random_slabs(rng, 1, 8, 2, 10, fill=1.0)
    arrs[3][:] = np.uint32(0xF0000000)
    fs = arrs[0][0, :, 0, 0].copy()
    fd = arrs[1][0, :, 0, 0].copy()
    rows = np.arange(8, dtype=np.int32)[:, None]
    cols = np.zeros((8, 1), np.int32)
    args = (to_torch(arrs), torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.bool),
            torch.from_numpy(fs.view(np.int32)),
            torch.from_numpy(fd.view(np.int32)), torch.from_numpy(rows),
            torch.from_numpy(cols))
    hit = tpr.edge_probe(*args, 0x80000000, 0xFFFFFFFF, match_time=True)
    miss = tpr.edge_probe(*args, 0, 0x7FFFFFFF, match_time=True)
    assert (hit.numpy() > 0).all() and (miss.numpy() == 0).all()


def test_wrappers_reject_other_devices():
    nodes = tcm.make_nodes(1, 4, 2, "meta")
    x = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    rc = torch.zeros((1, 4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tli.leaf_insert_batched(nodes, x, x, rc, rc, x.float(), x,
                                x.bool(), r=2)


# ---------------------------------------------------------------------------
# aggregation placement (Alg. 2): ordered float sums, bit-exact
# ---------------------------------------------------------------------------

def test_ordered_index_add_matches_np_add_at():
    rng = np.random.default_rng(9)
    base = rng.standard_normal(64).astype(np.float32)
    tgt = rng.integers(0, 8, 4000)                     # heavy repetition
    val = (rng.standard_normal(4000) * 1e3).astype(np.float32)
    want = base.copy()
    np.add.at(want, tgt, val)
    got = torch.from_numpy(base.copy())
    tcm._ordered_index_add(got, torch.from_numpy(tgt),
                           torch.from_numpy(val))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_children_matches_host_twin(level, seed):
    """Random parent-level coordinates with heavy collisions and float
    weights: the port's batched placement equals the reference's host
    twin (``aggregate_children_host``) slot for slot and bit for bit."""
    kw = dict(d1=4, F1=14, b=2, r=2)
    rp, tp = RefParams(**kw), HiggsParams(**kw)
    rng = np.random.default_rng(seed * 10 + level)
    m, n = 3, 400
    dp = rp.d(level + 1)
    F = rp.F(level + 1)
    ids = rng.integers(0, 12, (m, n))                  # few distinct edges
    fs = (ids * 7919 % (1 << F)).astype(np.uint32)
    fd = (ids * 104729 % (1 << F)).astype(np.uint32)
    rows = np.asarray(rcm.chain_from_base(ids % dp, 2, dp)).astype(np.uint32)
    cols = np.asarray(rcm.chain_from_base((ids // 3) % dp, 2, dp)
                      ).astype(np.uint32)
    w = rng.exponential(2.0, (m, n)).astype(np.float32)
    valid = rng.random((m, n)) < 0.9
    rows = np.where(valid[..., None], rows, np.uint32(0))
    cols = np.where(valid[..., None], cols, np.uint32(0))
    orders = rcm.host_round_orders(rows, cols, dp, 2)
    s4, wmat, spill = rcm.aggregate_children_host(
        fs, fd, rows, cols, w, valid, orders, rp, level)
    assert spill.any(), "no spill: test is vacuous"
    parents = tcm.make_nodes(m, dp, 2, "cpu")
    tspill = tcm.aggregate_children_pre(
        parents, *(torch.from_numpy(a.astype(np.int64))
                   for a in (fs, fd, rows, cols)),
        torch.from_numpy(w), torch.from_numpy(valid), params=tp)
    got = as_ref(parents)
    want = {"fp_s": s4[:, 0], "fp_d": s4[:, 1], "t": s4[:, 2],
            "idx": s4[:, 3], "w": wmat}
    for name, g in zip(FIELDS, got):
        np.testing.assert_array_equal(
            g.view(np.uint32), np.asarray(want[name]).view(np.uint32),
            err_msg=name)
    np.testing.assert_array_equal(tspill.numpy(), spill)


def test_library_name_follows_shared_headers(tmp_path, monkeypatch):
    # a library is named by a hash of its source and of the shared
    # headers, so an edited header rebuilds every source that includes it
    from repro_torch.kernels import _build
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    header = tmp_path / "common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    (tmp_path / "probe.cu").write_text(
        (tmp_path / "probe.cu").read_text() + "\n")
    assert _build._lib_path("probe") != after["probe"]
    assert _build._lib_path("leaf_insert") == after["leaf_insert"]


@pytest.mark.parametrize("L,d,b,r,n", [(2, 64, 3, 4, 300)])
def test_leaf_insert_batched_plain_large_leaf(L, d, b, r, n):
    """A leaf whose matrices exceed a block's shared memory on the card
    (64*64*3 slots, 240 KB staged), where the CUDA kernel walks the slabs
    in global memory: the plain version against the Pallas kernel."""
    rng = np.random.default_rng(64)
    items = insert_inputs(rng, (L, n), d, r, F=12)
    want, want_sp = leaf_insert_batched_pallas(
        rcm.make_nodes(L, d, b), *(jnp.asarray(a) for a in items), r=r,
        interpret=True)
    got, got_sp = tli.leaf_insert_batched(tcm.make_nodes(L, d, b, "cpu"),
                                          *torch_items(*items), r=r)
    assert d * d * b * 20 > 227 * 1024
    for name, g, wv in zip(FIELDS, as_ref(got), as_ref(want)):
        np.testing.assert_array_equal(g, wv, err_msg=name)
    np.testing.assert_array_equal(got_sp.numpy(), np.asarray(want_sp))
