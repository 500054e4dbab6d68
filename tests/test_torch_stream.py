"""The port's stream pipeline, fault handling, generators and loader: a
run killed and resumed through ``run_resumable`` ends bit-identical to an
uninterrupted one (with and without a window); cursor files are atomic
and a corrupt one raises; ``PreemptionGuard`` stops a run at a snapshot
and ``StragglerMonitor`` decides as the reference does; every generator
gives the reference's arrays for the same seed; ``load_konect`` reads a
file the test writes, plain and gzipped."""
import gzip
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.runtime import fault as ref_fault  # noqa: E402
from repro.stream import generator as ref_gen  # noqa: E402
from repro.stream import loader as ref_loader  # noqa: E402
from repro_torch import HiggsParams, HiggsSketch  # noqa: E402
from repro_torch.api.queries import EdgeQuery, VertexQuery  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.runtime.fault import (PreemptionGuard,  # noqa: E402
                                       StragglerMonitor,
                                       run_with_preemption)
from repro_torch.stream import generator, loader  # noqa: E402
from repro_torch.stream.pipeline import StreamPipeline  # noqa: E402

SMALL = dict(d1=4, F1=14, b=2, r=2)
T_SPAN = 1 << 27


@pytest.fixture(scope="module")
def stream():
    return generator.lkml_like_stream(3100, seed=3)


def assert_sketches_identical(a, b):
    (xa, ma), (xb, mb) = a.state_dict(), b.state_dict()
    assert sorted(xa) == sorted(xb) and ma == mb
    for k in xa:
        np.testing.assert_array_equal(xa[k], xb[k], err_msg=k)


def answers(sk, stream):
    src, dst = stream[0], stream[1]
    qs = [EdgeQuery(src[-50:], dst[-50:], 0, T_SPAN),
          VertexQuery(src[-30:], T_SPAN // 2, T_SPAN, "out"),
          VertexQuery(dst[-30:], 0, T_SPAN, "in")]
    return [np.asarray(v) for v in sk.query(qs).values]


@pytest.mark.parametrize("retention,kill_at,every,align", [
    ("none", 3, 2, True),
    (f"window:{T_SPAN // 4}", 5, 2, True),
    (f"window:{T_SPAN // 3}", 4, 3, False),
])
def test_kill_and_resume_is_bit_identical(tmp_path, stream, retention,
                                          kill_at, every, align):
    p = HiggsParams(retention=retention, **SMALL)
    ref = HiggsSketch(p, device="cpu")
    StreamPipeline(*stream, batch=256).feed(ref, align=align)

    d = str(tmp_path)
    pipe = StreamPipeline(*stream, batch=256)
    calls = [0]

    def stop():
        calls[0] += 1
        return calls[0] >= kill_at

    pipe.run_resumable(HiggsSketch(p, device="cpu"), d, every=every,
                       align=align, should_stop=stop, keep=2)
    assert pipe.cursor < len(pipe), "must die mid-stream"
    assert len(os.listdir(d)) <= 3        # keep=2, then the stop's own

    pipe2 = StreamPipeline(*stream, batch=256)
    sk2 = HiggsSketch(p, device="cpu")
    pipe2.run_resumable(sk2, d, every=every, align=align, keep=2)
    assert pipe2.cursor == len(pipe2)
    if retention != "none":
        assert sk2.segments.n_evicted > 0
    assert_sketches_identical(ref, sk2)
    for x, y in zip(answers(ref, stream), answers(sk2, stream)):
        np.testing.assert_array_equal(x, y)
    # a completed run restores its final snapshot and returns at once
    pipe3 = StreamPipeline(*stream, batch=256)
    sk3 = HiggsSketch(p, device="cpu")
    pipe3.run_resumable(sk3, d, every=every, align=align)
    assert_sketches_identical(ref, sk3)


def test_run_with_preemption_and_retention_hook(tmp_path, stream):
    p = HiggsParams(retention=f"window:{T_SPAN // 4}", **SMALL)
    ref = HiggsSketch(p, device="cpu")
    StreamPipeline(*stream, batch=300).feed(ref)
    guard = PreemptionGuard(install=False)
    pipe = StreamPipeline(*stream, batch=300)
    seen = []

    def hook(cursor, stats):
        seen.append((cursor, stats["segments_evicted"]))
        if cursor >= 1500:
            guard.request_stop()                     # "SIGTERM" mid-run

    run_with_preemption(pipe, HiggsSketch(p, device="cpu"), str(tmp_path),
                        every=2, guard=guard, on_retention=hook)
    assert guard.should_stop and pipe.cursor < len(pipe)
    assert store.latest_step(str(tmp_path)) == pipe.cursor
    sk2 = HiggsSketch(p, device="cpu")
    run_with_preemption(StreamPipeline(*stream, batch=300), sk2,
                        str(tmp_path), every=2,
                        guard=PreemptionGuard(install=False))
    assert_sketches_identical(ref, sk2)
    assert [c for c, _ in seen] == sorted(c for c, _ in seen)


def test_preemption_guard_signal_and_restore():
    import signal
    prev = signal.getsignal(signal.SIGTERM)
    hits = []
    g = PreemptionGuard(on_preempt=lambda: hits.append(1))
    try:
        assert not g.should_stop
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.should_stop and hits == [1]
    finally:
        g.restore()
    assert signal.getsignal(signal.SIGTERM) == prev


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(11)
    ours, theirs = StragglerMonitor(threshold=1.8, window=5), \
        ref_fault.StragglerMonitor(threshold=1.8, window=5)
    hosts = [f"h{i}" for i in range(6)]
    for step in range(40):
        for h in hosts:
            dt = float(rng.gamma(2.0, 1.0)) * (3.0 if h == "h4" else 1.0)
            ours.record(h, dt)
            theirs.record(h, dt)
        assert ours.stragglers() == theirs.stragglers()
        if step == 20:
            for m in (ours, theirs):
                for h in m.stragglers():
                    m.evict(h)
    assert ours.active_hosts() == theirs.active_hosts()
    assert ours.needs_elastic_restart() == theirs.needs_elastic_restart()
    assert ours.rebalanced_shards(13) == theirs.rebalanced_shards(13)


def test_cursor_file_is_atomic_and_corrupt_raises(tmp_path):
    arrs = [np.arange(90, dtype=np.uint32)] * 2 + \
        [np.ones(90, np.float32), np.arange(90, dtype=np.uint32)]
    pipe = StreamPipeline(*arrs, batch=30)
    path = str(tmp_path / "cursor.json")
    next(iter(pipe))
    pipe.save_cursor(path)
    assert os.listdir(tmp_path) == ["cursor.json"]
    other = StreamPipeline(*arrs, batch=7)
    other.restore_cursor(path)
    assert (other.cursor, other.batch) == (30, 30)
    other.restore_cursor(str(tmp_path / "missing.json"))  # a first run
    assert other.cursor == 30
    for bad in ("{\"cursor\": 3", json.dumps({"batch": 4}), "[]"):
        with open(path, "w") as fh:
            fh.write(bad)
        with pytest.raises(ValueError, match="corrupt cursor"):
            other.restore_cursor(path)


@pytest.mark.parametrize("name,kw", [
    ("power_law_stream", dict(n_edges=5000, skew=1.7, seed=2,
                              burstiness=2.0)),
    ("variance_stream", dict(n_edges=4000, variance=900.0, t_slots=512,
                             seed=1)),
    ("lkml_like_stream", dict(n_edges=4000, seed=3)),
    ("balanced_stream", dict(n_edges=4000, seed=5)),
    ("wiki_talk_like_stream", dict(n_edges=4000, seed=4)),
])
def test_generators_match_reference(name, kw):
    got = getattr(generator, name)(**kw)
    want = getattr(ref_gen, name)(**kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("gz", [False, True])
def test_load_konect_on_a_written_file(tmp_path, gz):
    lines = ["% sym unweighted", "% 7 4 4", "3 4 1 1200", "1 2 2.5 1000",
             "", "# a comment", "5 6 1 1000", "7 8", "9 1 3 900"]
    path = str(tmp_path / ("edges.tsv.gz" if gz else "edges.tsv"))
    opener = gzip.open if gz else open
    with opener(path, "wt") as fh:
        fh.write("\n".join(lines) + "\n")
    got = loader.load_konect(path)
    want = ref_loader.load_konect(path)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    src, dst, w, t = got
    assert t[0] == 0 and (np.diff(t.astype(np.int64)) >= 0).all()
    assert len(loader.load_konect(path, max_edges=3)[0]) == 3
    data = str(tmp_path)
    ours = loader.dataset_or_synthetic("edges", 10, data_dir=data)
    for g, w_ in zip(ours, got):
        np.testing.assert_array_equal(g, w_)
    for g, w_ in zip(loader.dataset_or_synthetic("lkml", 500, data),
                     ref_loader.dataset_or_synthetic("lkml", 500, data)):
        np.testing.assert_array_equal(g, w_)
