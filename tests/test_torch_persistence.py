"""Snapshots of the port: ``state_dict``/``load_state`` and ``save``/
``restore`` round trips are bit-identical (pending buffer, window state
and future inserts included); the on-disk layout is the reference's, so
a reference snapshot restores into the port and a port snapshot into the
reference with equal pools and answers; the store writes atomically and
sweeps what a crash mid-save left behind."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.api import queries as rq  # noqa: E402
from repro.checkpoint import store as ref_store  # noqa: E402
from repro.core.higgs import HiggsSketch as RefSketch  # noqa: E402
from repro.core.params import HiggsParams as RefParams  # noqa: E402
from repro_torch import HiggsParams, HiggsSketch  # noqa: E402
from repro_torch.api import queries as tq  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.stream.generator import lkml_like_stream  # noqa: E402

FIELDS = ("fp_s", "fp_d", "w", "t", "idx")
SMALL = dict(d1=4, F1=14, b=2, r=2)
T_SPAN = 1 << 27
RETENTION = {"none": "none", "window": f"window:{T_SPAN // 4}",
             "budget": "budget:30000"}


@pytest.fixture(scope="module")
def stream():
    return lkml_like_stream(3100, seed=3)


def feed(sk, stream, lo, hi, batch=700):
    for a in range(lo, hi, batch):
        sk.insert(*(x[a:min(a + batch, hi)] for x in stream))


def assert_state_dicts_equal(a, b):
    (xa, ma), (xb, mb) = a.state_dict(), b.state_dict()
    assert sorted(xa) == sorted(xb)
    for k in xa:
        assert xa[k].dtype == xb[k].dtype, k
        np.testing.assert_array_equal(xa[k], xb[k], err_msg=k)
    assert ma == mb


def assert_pools_equal(a, b):
    assert [(p.n, p.base) for p in a.pools] == \
        [(p.n, p.base) for p in b.pools]
    for i, (pa, pb) in enumerate(zip(a.pools, b.pools)):
        for name in FIELDS:
            if pa.n:
                np.testing.assert_array_equal(
                    pa.arrs[name][:pa.n].view(np.uint32),
                    pb.arrs[name][:pb.n].view(np.uint32),
                    err_msg=f"L{i + 1}/{name}")
    np.testing.assert_array_equal(a.leaf_ends, b.leaf_ends)
    assert list(a.ob.data) == list(b.ob.data)


def queries(mod, stream):
    src, dst = stream[0], stream[1]
    T = T_SPAN
    qs = []
    for ts, te in ((0, T), (T // 3, T // 2), (3 * T // 4, T),
                   (T - T // 50, T)):
        qs += [mod.EdgeQuery(src[-64:], dst[-64:], ts, te),
               mod.VertexQuery(src[-40:], ts, te, "out"),
               mod.VertexQuery(dst[-40:], ts, te, "in"),
               mod.PathQuery(src[-6:], ts, te),
               mod.SubgraphQuery(np.stack([src[-9:], dst[-9:]], 1), ts, te)]
    return qs


def assert_same_answers(a, b, stream, mods=(tq, tq)):
    for x, y in zip(a.query(queries(mods[0], stream)).values,
                    b.query(queries(mods[1], stream)).values):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


@pytest.mark.parametrize("policy", list(RETENTION))
def test_port_save_restore_is_bit_identical(tmp_path, stream, policy):
    """Saved mid-stream (a pending partial leaf in the buffer), restored
    into a sketch of other params: equal state, answers, and state after
    the same future inserts."""
    kw = dict(SMALL, retention=RETENTION[policy])
    sk = HiggsSketch(HiggsParams(**kw), device="cpu")
    feed(sk, stream, 0, 2050)
    assert sk._buf_len > 0
    if policy != "none":
        assert sk.segments.n_evicted + sk.segments.n_coarse > 0
    sk.save(str(tmp_path), 7)
    got = HiggsSketch(HiggsParams(), device="cpu")
    got.restore(str(tmp_path))
    assert got.params == sk.params and got.device == sk.device
    assert got.structure_version == sk.structure_version
    assert_state_dicts_equal(sk, got)
    assert_same_answers(sk, got, stream)
    for s in (sk, got):
        feed(s, stream, 2050, len(stream[0]))
        s.flush()
    assert_state_dicts_equal(sk, got)
    assert_same_answers(sk, got, stream)


def test_state_dict_layout_is_the_references(stream):
    """Key for key, dtype for dtype, and the same metadata keys."""
    kw = dict(SMALL, retention=RETENTION["window"])
    ref = RefSketch(RefParams(insert_backend="pallas", pool_storage="host",
                              interpret=True, batched_ingest=True, **kw))
    port = HiggsSketch(HiggsParams(**kw), device="cpu")
    for s in (ref, port):
        feed(s, stream, 0, 2050)
    (xr, mr), (xp, mp) = ref.state_dict(), port.state_dict()
    assert sorted(xr) == sorted(xp)
    for k in xr:
        assert xr[k].dtype == xp[k].dtype, k
        np.testing.assert_array_equal(xp[k], xr[k], err_msg=k)
    assert sorted(mr) == sorted(mp)
    for k in ("n_items", "buf_len", "version", "ob_keys", "t_last",
              "segments"):
        assert mp[k] == mr[k], k
    assert [{k: p[k] for k in ("n", "d", "b", "base")} for p in mp["pools"]] \
        == [{k: p[k] for k in ("n", "d", "b", "base")} for p in mr["pools"]]


def test_reference_snapshot_restores_into_port(tmp_path, stream):
    kw = dict(SMALL, retention=RETENTION["window"])
    ref = RefSketch(RefParams(insert_backend="pallas", pool_storage="host",
                              interpret=True, batched_ingest=True, **kw))
    feed(ref, stream, 0, 2050)
    ref.save(str(tmp_path), 3)
    port = HiggsSketch(HiggsParams(), device="cpu")
    port.restore(str(tmp_path))
    assert port.params.retention.kind == "window"
    assert_pools_equal(ref, port)
    assert_same_answers(ref, port, stream, mods=(rq, tq))
    # both go on as one: the port runs the reference's pallas engine
    for s in (ref, port):
        feed(s, stream, 2050, len(stream[0]))
        s.flush()
    assert_pools_equal(ref, port)
    assert port.segments.meta() == ref.segments.meta()
    assert_same_answers(ref, port, stream, mods=(rq, tq))


@pytest.mark.parametrize("policy", ["none", "budget"])
def test_port_snapshot_restores_into_reference(tmp_path, stream, policy):
    port = HiggsSketch(HiggsParams(**SMALL, retention=RETENTION[policy]),
                       device="cpu")
    feed(port, stream, 0, len(stream[0]))
    port.flush()
    port.save(str(tmp_path), 11)
    ref = RefSketch(RefParams())
    ref.restore(str(tmp_path))
    assert ref.retention_stats() == port.retention_stats()
    assert_pools_equal(port, ref)
    assert_same_answers(ref, port, stream, mods=(rq, tq))


def test_store_layout_crosses_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"b/x": rng.integers(0, 9, (3, 4)).astype(np.uint32),
              "a": rng.random(5).astype(np.float32),
              "c.1/w": np.zeros((0,), np.float64)}
    meta = {"summary": "higgs", "state": {"k": [1, 2]}}
    store.save_checkpoint(str(tmp_path / "p"), 2, arrays, meta)
    ref_store.save_checkpoint(str(tmp_path / "r"), 2, arrays, meta)
    for d in ("p", "r"):
        assert store.read_manifest(str(tmp_path / d), 2) == \
            ref_store.read_manifest(str(tmp_path / "r"), 2)
        for load in (store.restore_arrays, ref_store.restore_arrays):
            got, m = load(str(tmp_path / d), 2)
            assert m == meta and sorted(got) == sorted(arrays)
            for k in arrays:
                assert got[k].dtype == arrays[k].dtype
                np.testing.assert_array_equal(got[k], arrays[k])


def test_store_is_atomic_and_sweeps_stale_tmp(tmp_path, monkeypatch):
    d = str(tmp_path)
    one = {"x": np.arange(4, dtype=np.uint32)}
    store.save_checkpoint(d, 1, one, {"summary": "higgs", "state": {}})

    def torn(*a, **k):
        raise OSError("preempted mid-write")

    monkeypatch.setattr(store.np, "savez", torn)
    with pytest.raises(OSError):
        store.save_checkpoint(d, 2, one, {"summary": "higgs", "state": {}})
    monkeypatch.undo()
    assert os.path.isdir(os.path.join(d, ".tmp_step_2"))
    assert store.latest_step(d) == 1                # the torn save is unseen
    _, _, step = store.load_snapshot(d)
    assert step == 1
    store.save_checkpoint(d, 3, one, {"summary": "higgs", "state": {}})
    assert sorted(os.listdir(d)) == ["step_1", "step_3"]
    assert store.gc_checkpoints(d, keep=1) == [1]
    assert os.listdir(d) == ["step_3"]
    with pytest.raises(ValueError, match="not 'tcm'"):
        store.load_snapshot(d, expect_kind="tcm")
    with pytest.raises(FileNotFoundError):
        store.load_snapshot(str(tmp_path / "empty"))
