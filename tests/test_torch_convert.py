"""Reference state carried into the port, and the port's isolation from
the reference: a reference ``state_dict()`` loaded through
``sketch_from_reference_state`` answers every query as the reference
does, and importing ``repro_torch`` pulls in neither ``jax`` nor
``repro``."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.api import queries as rq  # noqa: E402
from repro.core.higgs import HiggsSketch as RefSketch  # noqa: E402
from repro.core.params import HiggsParams as RefParams  # noqa: E402
from repro_torch import (HiggsParams, HiggsSketch,  # noqa: E402
                         sketch_from_reference_state)
from repro_torch.api import queries as tq  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stream(seed, n=1500, nv=50, t_max=5000):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nv, n).astype(np.uint32),
            rng.integers(0, nv, n).astype(np.uint32),
            rng.integers(1, 10, n).astype(np.float32),
            np.sort(rng.integers(0, t_max, n).astype(np.uint32)))


def batches(s, ranges):
    src, dst = s[0], s[1]
    out = []
    for mod in (rq, tq):
        qs = []
        for ts, te in ranges:
            qs += [mod.EdgeQuery(src[:64], dst[:64], ts, te),
                   mod.VertexQuery(src[:40], ts, te, "out"),
                   mod.VertexQuery(dst[:40], ts, te, "in"),
                   mod.PathQuery(src[:6], ts, te),
                   mod.SubgraphQuery(np.stack([src[:9], dst[:9]], 1), ts, te)]
        out.append(qs)
    return out


@pytest.mark.parametrize("backend,kw", [
    ("host", dict(d1=4, F1=14, b=2, r=2)),      # reference CPU default
    ("pallas", dict(d1=8, F1=16, b=3, r=2)),
])
def test_reference_state_answers_equal(backend, kw):
    s = stream(7)
    ref = RefSketch(RefParams(insert_backend=backend, pool_storage="host",
                              interpret=True, batched_ingest=True, **kw))
    ref.insert(*(a[:1400] for a in s))          # last items stay pending
    arrays, meta = ref.state_dict()
    assert arrays["buf"].shape[1] > 0
    port = sketch_from_reference_state(arrays, meta, device="cpu")
    assert port.structure_version == ref.structure_version
    assert [p.n for p in port.pools] == [p.n for p in ref.pools]
    ranges = [(0, 5000), (1000, 3000), (4000, 4100), (3000, 1000)]
    rqs, tqs = batches(s, ranges)
    for x, y in zip(ref.query(rqs).values, port.query(tqs).values):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    # the pending buffer came along: flushing closes the same last leaf
    ref.flush()
    port.flush()
    np.testing.assert_array_equal(port.leaf_ends, ref.leaf_ends)
    for x, y in zip(ref.query(rqs).values, port.query(tqs).values):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import sys, importlib, pkgutil\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "new = ('api.protocol', 'checkpoint.store', 'runtime.fault', "
        "'stream.pipeline', 'stream.loader')\n"
        "assert all('repro_torch.' + m in sys.modules for m in new)\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 22       # every submodule imported


def test_default_device_is_cuda_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HiggsSketch(HiggsParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sketch_from_reference_state(*RefSketch(RefParams()).state_dict())
