"""Carry a reference sketch's state into the port.

``sketch_from_reference_state`` takes exactly what the reference's
``repro.core.higgs.HiggsSketch.state_dict()`` returns — numpy pool slabs
(trimmed to their node counts, capacities in the metadata), leaf
intervals, overflow-block columns, the pending raw-item buffer, the
segment lifecycle and the params — and returns a port
:class:`HiggsSketch` that answers every query as the reference does.  It
goes through the port's own ``load_state``; nothing here imports the
reference.

The reference may have been built with any insert engine; the loaded
state answers the same either way, and items inserted afterwards go
through the port's engine (the reference's ``insert_backend="pallas"``
with device pools).
"""
from __future__ import annotations

from repro_torch.core.higgs import HiggsSketch
from repro_torch.core.params import HiggsParams


def sketch_from_reference_state(arrays: dict, meta: dict, device=None,
                                kernels: bool = True) -> HiggsSketch:
    """A port sketch on ``device`` (``None`` = CUDA) holding the state of
    a reference ``state_dict()`` ``(arrays, meta)``."""
    sk = HiggsSketch(HiggsParams(), device=device, kernels=kernels)
    sk.load_state(arrays, meta)
    return sk
