"""Port hashing and coordinate helpers against the JAX reference,
bit for bit (repro_torch.core.hashing / cmatrix vs repro.core)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import cmatrix as rcm  # noqa: E402
from repro.core import hashing as rh  # noqa: E402
from repro.core.params import HiggsParams as RefParams  # noqa: E402
from repro_torch.core import cmatrix as tcm  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core.params import HiggsParams  # noqa: E402

SEED = 0x9E3779B9


def u32(x):
    """Unsigned 32-bit numpy view of a torch/jax/numpy integer array."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64).astype(np.uint32) if a.dtype == np.int64 \
        else a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


@pytest.fixture(scope="module")
def ids():
    rng = np.random.default_rng(11)
    return rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("seed", [SEED, SEED ^ 0x5BD1E995, 0])
def test_mix32_bit_exact(ids, seed):
    want = np.asarray(rh.mix32(jnp.asarray(ids), seed))
    got = th.mix32(torch.from_numpy(ids.view(np.int32)), seed)
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(th.np_mix32(ids, seed), want)
    np.testing.assert_array_equal(th.np_mix32(ids, seed),
                                  rh.np_mix32(ids, seed))


@pytest.mark.parametrize("F,d,r", [(19, 16, 4), (14, 4, 2), (12, 32, 1)])
def test_fingerprint_address_chain(ids, F, d, r):
    h = rh.np_mix32(ids, SEED)
    ht = th.as_u32(torch.from_numpy(h.view(np.int32)))
    np.testing.assert_array_equal(u32(th.fingerprint(ht, F)),
                                  np.asarray(rh.fingerprint(h, F)))
    addr = np.asarray(rh.address(h, F, d))
    np.testing.assert_array_equal(u32(th.address(ht, F, d)), addr)
    np.testing.assert_array_equal(
        u32(th.lcg_chain(torch.from_numpy(addr.astype(np.int64)), r, d)),
        np.asarray(rh.lcg_chain(addr, r, d)))
    np.testing.assert_array_equal(th.np_lcg_chain(addr, r, d),
                                  rh.np_lcg_chain(addr, r, d))
    np.testing.assert_array_equal(
        u32(tcm.chain_from_base(torch.from_numpy(addr.astype(np.int64)),
                                r, d)),
        np.asarray(rcm.chain_from_base(addr, r, d)))


@pytest.mark.parametrize("level", [1, 2, 4])
def test_shift_up_and_level_split(ids, level):
    p = RefParams()
    h = rh.np_mix32(ids, SEED)
    ht = th.as_u32(torch.from_numpy(h.view(np.int32)))
    fp, addr = rh.level_fp_addr(h, p.F1, p.d1, level, p.R)
    tfp, taddr = th.level_fp_addr(ht, p.F1, p.d1, level, p.R)
    np.testing.assert_array_equal(u32(tfp), np.asarray(fp))
    np.testing.assert_array_equal(u32(taddr), np.asarray(addr))
    F_child = p.F(level)
    want = rh.shift_up(fp, addr, p.R, F_child)
    got = th.shift_up(tfp, taddr, p.R, F_child)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(u32(g), np.asarray(w_))


@pytest.mark.parametrize("r,d", [(4, 16), (2, 4), (4, 64)])
def test_lcg_tables_and_base_recovery(r, d):
    for a, b in zip(tcm.lcg_tables(r, d), rcm.lcg_tables(r, d)):
        np.testing.assert_array_equal(a, b.astype(np.int64))
    rng = np.random.default_rng(r * d)
    x0 = rng.integers(0, d, 512).astype(np.uint32)
    k = rng.integers(0, r, 512).astype(np.int32)
    x_k = np.asarray(rcm.chain_from_base(x0, r, d))[np.arange(512), k]
    want = np.asarray(rcm.chain_base_from_pos(x_k, k, r, d))
    got = tcm.chain_base_from_pos(torch.from_numpy(x_k.astype(np.int64)),
                                  torch.from_numpy(k.astype(np.int64)), r, d)
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(want, x0)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("side", ["s", "d"])
def test_recover_and_coords_at_level(level, side):
    kw = dict(d1=16, F1=19, b=3, r=4)
    rp, tp = RefParams(**kw), HiggsParams(**kw)
    rng = np.random.default_rng(level * 7 + (side == "d"))
    n = 2048
    d = rp.d(level)
    addr = rng.integers(0, d, n).astype(np.uint32)
    fp = rng.integers(0, 1 << rp.F(level), n).astype(np.uint32)
    idx = rng.integers(0, rp.r * rp.r, n).astype(np.uint32)
    f1, base = rcm.recover_leaf_coords(jnp.asarray(addr), jnp.asarray(fp),
                                       jnp.asarray(idx), level, rp, side)
    hf1, hbase = rcm.host_recover_leaf_coords(addr, fp, idx, level, rp, side)
    tf1, tbase = tcm.recover_leaf_coords(
        *(torch.from_numpy(a.view(np.int32)) for a in (addr, fp, idx)),
        level, tp, side)
    for got, want in ((tf1, f1), (tbase, base), (tf1, hf1), (tbase, hbase)):
        np.testing.assert_array_equal(u32(got), np.asarray(want))
    for plevel in (level, level + 1):
        want = rcm.coords_at_level(f1, base, plevel, rp)
        hwant = rcm.host_coords_at_level(np.asarray(f1), np.asarray(base),
                                         plevel, rp)
        got = tcm.coords_at_level(tf1, tbase, plevel, tp)
        for g, w_, hw in zip(got, want, hwant):
            np.testing.assert_array_equal(u32(g), np.asarray(w_))
            np.testing.assert_array_equal(u32(g), hw)


@pytest.mark.parametrize("m,n,d,r", [(1, 300, 16, 4), (3, 200, 64, 2),
                                     (2, 500, 1024, 4)])
def test_round_orders_match_host_and_device(m, n, d, r):
    rng = np.random.default_rng(m + n + d)
    rows = rng.integers(0, d, (m, n, r)).astype(np.uint32)
    cols = rng.integers(0, d, (m, n, r)).astype(np.uint32)
    want = rcm.host_round_orders(rows, cols, d, r)
    np.testing.assert_array_equal(
        np.asarray(rcm.round_orders(jnp.asarray(rows), jnp.asarray(cols), r)),
        want)
    got = tcm.round_orders(torch.from_numpy(rows.astype(np.int64)),
                           torch.from_numpy(cols.astype(np.int64)), r)
    np.testing.assert_array_equal(got.numpy(), want)


def test_as_u32_reads_int32_storage_unsigned():
    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    got = th.as_u32(torch.from_numpy(vals.view(np.int32)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), vals.astype(np.int64))
    assert int(th.as_u32(torch.tensor([tcm.EMPTY]))[0]) == 0xFFFFFFFF
