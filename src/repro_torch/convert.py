"""Carry a reference sketch's state into the port.

``sketch_from_reference_state`` takes exactly what the reference's
``repro.core.higgs.HiggsSketch.state_dict()`` returns — numpy pool slabs
(trimmed to their node counts, capacities in the metadata), leaf
intervals, overflow-block columns, the pending raw-item buffer and the
params — and returns a port :class:`HiggsSketch` that answers every query
as the reference does.  It is the port's counterpart of the reference's
``load_state``; nothing here imports the reference.

The reference may have been built with any insert engine; the loaded
state answers the same either way, and items inserted afterwards go
through the port's engine (the reference's ``insert_backend="pallas"``
with device pools).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.higgs import HiggsSketch, _LevelPool, _OverflowStore
from repro_torch.core.params import HiggsParams

_NODE_FIELDS = ("fp_s", "fp_d", "w", "t", "idx")


def sketch_from_reference_state(arrays: dict, meta: dict, device=None,
                                kernels: bool = True) -> HiggsSketch:
    """A port sketch on ``device`` (``None`` = CUDA) holding the state of
    a reference ``state_dict()`` ``(arrays, meta)``."""
    cfg = dict(meta["config"])
    cfg.update(insert_backend="pallas", pool_storage="device",
               batched_ingest=True, interpret=None)
    sk = HiggsSketch(HiggsParams(**cfg), device=device, kernels=kernels)
    for lvl, pm in enumerate(meta["pools"], start=1):
        if lvl > len(sk.pools):
            sk.pools.append(_LevelPool(int(pm["d"]), int(pm["b"]),
                                       sk.device))
        sk.pools[lvl - 1].load(
            {name: arrays[f"pool{lvl}/{name}"] for name in _NODE_FIELDS},
            int(pm["n"]), cap=int(pm["cap"]), base=int(pm.get("base", 0)))
    sk._leaves.load(arrays["leaf_starts"], arrays["leaf_ends"])
    sk.ob.load({(int(lvl), int(node)):
                {f: arrays[f"ob/{lvl}.{node}/{f}"]
                 for f in _OverflowStore.FIELDS}
                for lvl, node in meta["ob_keys"]})
    buf = np.ascontiguousarray(arrays["buf"], np.uint32)
    sk._buf = [buf] if buf.shape[1] else []
    sk._buf_len = int(meta["buf_len"])
    sk.n_items = int(meta["n_items"])
    sk._t_last = int(meta.get("t_last", 0))
    sk.segments.load(meta.get("segments"))
    sk._version = int(meta["version"])
    sk.planner.invalidate()
    return sk
