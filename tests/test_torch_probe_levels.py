"""K3 over all the probe entries of an edge batch (``edge_probe_levels``)
against the JAX reference: the same numpy-seeded level slabs and queries
go through the reference's Pallas edge probe (interpret mode), one call
per entry at the entry's level coordinates, and through the port's entry
list in one call, whose plain version derives each level's coordinates
from the leaf-level fingerprints and chains.  Exact on integer weights,
rtol 1e-6 on float weights (as tests/test_kernels.py holds the
reference).  The CUDA kernel runs only on a card (tests/test_torch_gpu.py).
"""
import ctypes
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
from repro.kernels.probe import edge_probe_pallas  # noqa: E402
from repro_torch.core import cmatrix as tcm  # noqa: E402
from repro_torch.core.cmatrix import NodeState  # noqa: E402
from repro_torch.core.params import HiggsParams  # noqa: E402
from repro_torch.kernels import probe as tpr  # noqa: E402

_edge_pallas = jax.jit(functools.partial(edge_probe_pallas, interpret=True),
                       static_argnames=("match_time",))

TS, TE = 100, 700


def level_slabs(rng, cap, d, b, F, float_w):
    """Reference-dtype fields (cap, d, d, b), half the slots occupied by
    F-bit fingerprints."""
    shape = (cap, d, d, b)
    occ = rng.random(shape) < 0.5
    fp_s = np.where(occ, rng.integers(0, 1 << F, shape), REF_EMPTY)
    fp_d = np.where(occ, rng.integers(0, 1 << F, shape), REF_EMPTY)
    w = rng.exponential(3.0, shape) if float_w \
        else rng.integers(1, 100, shape)
    return [fp_s.astype(np.uint32), fp_d.astype(np.uint32),
            np.where(occ, w, 0).astype(np.float32),
            rng.integers(0, 1000, shape).astype(np.uint32),
            np.zeros(shape, np.uint32)]


def ref_coords(f1, base, level, rp):
    fp, rows = rcm.coords_at_level(jnp.asarray(f1), jnp.asarray(base),
                                   level, rp)
    return np.asarray(fp), np.asarray(rows).astype(np.int32)


def make_case(seed, n_levels, q, float_w, **kw):
    """Params, per-level slabs, entries (every level, then a time-filtered
    level-1 entry, as the planner orders them) and leaf-level queries;
    half the queries are planted on a candidate bucket of each entry."""
    p = HiggsParams(**kw)
    rp = RefParams(**kw)
    r = p.r if p.use_mmb else 1
    rng = np.random.default_rng(seed)
    f1s = rng.integers(0, 1 << p.F1, q, dtype=np.uint64).astype(np.uint32)
    f1d = rng.integers(0, 1 << p.F1, q, dtype=np.uint64).astype(np.uint32)
    bs = rng.integers(0, p.d1, q).astype(np.uint32)
    bd = rng.integers(0, p.d1, q).astype(np.uint32)
    slabs, plan = {}, []
    for level in range(1, n_levels + 1):
        m = int(rng.integers(1, 5))
        cap = m + 2
        slabs[level] = level_slabs(rng, cap, p.d(level), p.b, p.F(level),
                                   float_w)
        plan.append((level, m, cap, False))
    plan.append((1, 2, len(slabs[1][0]), True))          # filtered leaves
    specs = []
    for level, m, cap, match_time in plan:
        arrs = slabs[level]
        idx = rng.permutation(cap)[:m].astype(np.int32)
        mask = rng.random(m) < 0.75
        mask[0] = True
        fs, rows = ref_coords(f1s, bs, level, rp)
        fd, cols = ref_coords(f1d, bd, level, rp)
        live = idx[mask]
        for i in range(0, q, 2):
            c = (live[rng.integers(0, len(live))],
                 rows[i, rng.integers(0, r)], cols[i, rng.integers(0, r)],
                 rng.integers(0, p.b))
            arrs[0][c], arrs[1][c] = fs[i], fd[i]
            arrs[2][c] = rng.integers(1, 100)
            arrs[3][c] = rng.integers(TS, TE + 1)
        specs.append((level, idx, mask, match_time, fs, fd, rows, cols))
    return p, r, slabs, specs, (f1s, bs, f1d, bd)


def to_slabs(arrs) -> NodeState:
    return NodeState(*(torch.from_numpy(np.ascontiguousarray(
        a.view(np.float32 if i == 2 else np.int32))) for i, a in
        enumerate(arrs)))


def port_levels(p, r, slabs, specs, leaf, n=None):
    f1s, bs, f1d, bd = leaf
    tslabs = {lvl: to_slabs(a) for lvl, a in slabs.items()}
    entries = [tpr.EdgeEntry(tslabs[level], idx, mask, level, TS, TE, mt)
               for level, idx, mask, mt, *_ in specs[:n]]

    def chain(base):
        return tcm.chain_from_base(torch.from_numpy(base.astype(np.int64)),
                                   r, p.d1).to(torch.int32)

    return tpr.edge_probe_levels(
        entries, torch.from_numpy(f1s.view(np.int32)), chain(bs),
        torch.from_numpy(f1d.view(np.int32)), chain(bd), params=p).numpy()


def ref_levels(slabs, specs):
    out = []
    for level, idx, mask, mt, fs, fd, rows, cols in specs:
        nodes = RefNodes(*(jnp.asarray(a[idx]) for a in slabs[level]))
        out.append(np.asarray(_edge_pallas(
            nodes, jnp.asarray(mask), jnp.asarray(fs), jnp.asarray(fd),
            jnp.asarray(rows), jnp.asarray(cols), np.uint32(TS),
            np.uint32(TE), match_time=mt)))
    return np.stack(out)


def check(got, want, float_w):
    if float_w:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_levels,q,kw", [
    (1, 16, dict(d1=8, F1=14, b=3, r=4)),
    (7, 20, dict(d1=2, F1=12, b=3, r=2)),           # seven levels
    (3, 24, dict(d1=4, F1=12, b=1, r=2, use_mmb=False)),
    (2, 12, dict(d1=4, F1=12, b=9, r=4)),
    (5, 10, dict(d1=2, F1=5, b=3, r=2)),            # F = 1 at level 5
    (3, 8, dict(d1=4, F1=13, b=2, r=3, theta=16)),  # two bits per level
    (2, 1, dict(d1=8, F1=12, b=3, r=4)),            # one query
])
@pytest.mark.parametrize("float_w", [False, True])
def test_edge_probe_levels_plain_matches_reference(n_levels, q, kw,
                                                   float_w):
    p, r, slabs, specs, leaf = make_case(n_levels * 100 + q, n_levels, q,
                                         float_w, **kw)
    want = ref_levels(slabs, specs)
    before = tpr.edge_probe.launches
    got = port_levels(p, r, slabs, specs, leaf)
    assert tpr.edge_probe.launches == before          # CPU: plain version
    assert got.shape == (len(specs), q) and got.dtype == np.float32
    check(got, want, float_w)
    assert (want[:, ::2] > 0).any(axis=1).all()      # the planted hits


def test_edge_probe_levels_no_queries_and_no_entries():
    p, r, slabs, specs, leaf = make_case(5, 3, 0, False, d1=4, F1=12, b=3,
                                         r=2)
    assert port_levels(p, r, slabs, specs, leaf).shape == (len(specs), 0)
    p, r, slabs, specs, leaf = make_case(6, 2, 4, False, d1=4, F1=12, b=3,
                                         r=2)
    assert port_levels(p, r, slabs, specs, leaf, n=0).shape == (0, 4)


def test_edge_probe_levels_rows_equal_single_level_probes():
    """Row k of the batch equals ``edge_probe`` of entry k at its level's
    coordinates (``cmatrix.coords_at_level``)."""
    p, r, slabs, specs, leaf = make_case(9, 4, 12, False, d1=4, F1=12,
                                         b=3, r=4)
    got = port_levels(p, r, slabs, specs, leaf)
    f1s, bs, f1d, bd = (torch.from_numpy(a.astype(np.int64)) for a in leaf)
    for k, (level, idx, mask, mt, *_) in enumerate(specs):
        fs, rows = tcm.coords_at_level(f1s, bs, level, p)
        fd, cols = tcm.coords_at_level(f1d, bd, level, p)
        i32 = torch.int32
        one = tpr.edge_probe(
            to_slabs(slabs[level]), torch.from_numpy(idx),
            torch.from_numpy(mask), fs.to(i32), fd.to(i32), rows.to(i32),
            cols.to(i32), TS, TE, match_time=mt).numpy()
        np.testing.assert_array_equal(got[k], one, err_msg=f"entry {k}")


def test_edge_entry_layout_matches_the_kernel():
    """The ctypes descriptor is the 64-byte ``EdgeEntry`` of probe.cu."""
    assert ctypes.sizeof(tpr._EdgeEntry) == 64
    assert tpr._EdgeEntry.m.offset == 36 and tpr._EdgeEntry.ts.offset == 48
    assert tpr._EdgeEntry.match_time.offset == 56


def test_edge_probe_levels_rejects_other_devices():
    p = HiggsParams(d1=4, F1=12, b=3, r=2)
    r = 2
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    rows = torch.zeros((4, r), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpr.edge_probe_levels([], meta, rows, meta, rows, params=p)
