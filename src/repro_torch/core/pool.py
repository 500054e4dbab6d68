"""Level pools: the closed-node matrices of one tree level as persistent
tensors on the sketch's device (port of ``repro.core.pool``).

``_LevelPool`` is the single owner of the slab tensors (the reference's
higgslint R2 contract: other code goes through its API).  Each field is
one ``(cap, d, d, b)`` tensor (``int32`` bit patterns for the reference's
``uint32`` fields, ``float32`` weights); capacity doubles when an append
needs room, and unused capacity holds fresh-node contents (EMPTY
fingerprints, zeros), so kernels can write new nodes straight into the
rows past ``n``.  Where the reference donates device slabs to a jitted
step and adopts the returned buffers, the port writes in place.

Node ids are **global**: ``base`` counts nodes dropped from the front
(retention), so global id ``u`` lives at physical slot ``u - base``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.cmatrix import EMPTY, NodeState, make_nodes


class _LevelPool:
    """Closed-node matrices for one tree level, resident on ``device``."""

    def __init__(self, d: int, b: int, device):
        self.d, self.b = d, b
        self.device = torch.device(device)
        self.n = 0
        self.cap = 0
        self.base = 0
        self.slabs: Optional[NodeState] = None
        # mutation epoch: bumped on every write so the cached host view
        # below invalidates without eager copies
        self._version = 0
        self._host_mirror: tuple[int, Optional[dict]] = (-1, None)

    @property
    def total(self) -> int:
        """Global node count ever appended (retained + dropped)."""
        return self.base + self.n

    @property
    def arrs(self) -> Optional[dict]:
        """Host numpy arrays of the full-capacity slabs with the
        reference's dtypes (``uint32`` fields, ``float32`` weights): on
        a CUDA device a copy fetched at most once per mutation epoch (a
        device-to-host barrier, meant for inspection and tests), on the
        CPU views of the live storage."""
        if self.slabs is None:
            return None
        ver, cached = self._host_mirror
        if ver != self._version or cached is None:
            cached = {}
            for name, f in zip(NodeState._fields, self.slabs):
                a = f.cpu().numpy()
                cached[name] = a if name == "w" else a.view(np.uint32)
            self._host_mirror = (self._version, cached)
        return cached

    def _dirty(self) -> None:
        self._version += 1

    # -- lifecycle -------------------------------------------------------

    def drop_prefix(self, k: int) -> None:
        """Reclaim the ``k`` oldest retained slots: the retained suffix
        slides to the front in place (a ``clone`` per field, so an
        eviction briefly holds one more retained slab), capacity is kept,
        and the ``k`` slots it vacates get fresh-node contents again, as
        the kernels expect past ``n``."""
        if k <= 0:
            return
        if k > self.n:
            raise ValueError(f"cannot drop {k} of {self.n} nodes")
        for name, f in zip(NodeState._fields, self.slabs):
            f[: self.n - k] = f[k:self.n].clone()
            f[self.n - k:self.n] = EMPTY if name in ("fp_s", "fp_d") else 0
        self.n -= k
        self.base += k
        self._dirty()

    def _grow(self, new_cap: int) -> None:
        new = make_nodes(new_cap, self.d, self.b, self.device)
        if self.slabs is not None and self.n:
            for dst, src in zip(new, self.slabs):
                dst[: self.n] = src[: self.n]
        self.slabs = new
        self.cap = new_cap
        self._dirty()

    def reserve(self, need: int) -> None:
        """Grow capacity (power-of-two schedule, floor 4) to hold ``need``
        nodes without writing any."""
        if need <= self.cap:
            return
        cap = max(4, self.cap)
        while cap < need:
            cap *= 2
        self._grow(cap)

    def load(self, arrs: dict, n: int, cap: int | None = None,
             base: int = 0) -> None:
        """Overwrite with ``n`` nodes from host arrays (reference dtypes
        or their bit patterns), re-grown to the saved capacity."""
        self.slabs = None
        self.n = self.cap = 0
        self.base = int(base)
        cap = max(cap if cap is not None else n, n)
        if cap:
            self._grow(cap)
            for name, dst in zip(NodeState._fields, self.slabs):
                a = np.ascontiguousarray(arrs[name][:n])
                a = a.view(np.float32 if name == "w" else np.int32)
                dst[:n] = torch.from_numpy(a).to(self.device)
        self.n = n
        self._dirty()

    # -- appends ---------------------------------------------------------

    def rows(self, i0: int, count: int) -> NodeState:
        """Views of physical slots ``[i0, i0 + count)`` (contiguous): the
        ingest and aggregation steps read children and write new nodes
        here, in place."""
        if i0 < 0 or i0 + count > self.cap:
            raise ValueError(f"slots [{i0}, {i0 + count}) outside capacity "
                             f"{self.cap}")
        return NodeState(*(f[i0:i0 + count] for f in self.slabs))

    def adopt_slabs(self, slabs: NodeState, count: int) -> int:
        """Adopt fused-step output: ``count`` nodes were written in place
        into ``slabs`` (this pool's own) past ``self.n``.  Returns the
        base slot of the batch."""
        if slabs is not self.slabs:
            raise ValueError("adopt_slabs expects this pool's own slabs")
        if self.n + count > self.cap:
            raise ValueError("adopt_slabs past capacity")
        base = self.n
        self.n += count
        self._dirty()
        return base

    # -- reads -----------------------------------------------------------

    def slots_of(self, ids) -> np.ndarray:
        """Physical slot indices ``(m,)`` int32 of **global** ids, on the
        host."""
        return (np.asarray(ids, np.int64) - self.base).astype(np.int32)

    def gather_ids(self, ids) -> tuple[torch.Tensor, torch.Tensor]:
        """Physical slot indices ``(m,)`` int32 and an all-true mask for
        a probe over **global** ids, on the pool's device (the row take
        itself happens inside the probe kernel)."""
        idx_t = torch.from_numpy(self.slots_of(ids)).to(self.device)
        return idx_t, torch.ones(idx_t.shape, dtype=torch.bool,
                                 device=self.device)

    def gather_block(self, u0: int, count: int) -> dict:
        """Host numpy copy (reference dtypes) of ``count`` nodes from
        **global** id ``u0`` — a bounded device-to-host barrier."""
        i0 = u0 - self.base
        if i0 < 0 or i0 + count > self.n:
            raise ValueError(
                f"block [{u0}, {u0 + count}) outside retained window "
                f"[{self.base}, {self.base + self.n})")
        out = {}
        for name, f in zip(NodeState._fields, self.rows(i0, count)):
            a = f.cpu().numpy()
            out[name] = a if name == "w" else a.view(np.uint32)
        return out

    def export(self) -> dict:
        """Host numpy copies (reference dtypes) of the ``n`` retained
        nodes, one copy per field: what a snapshot stores."""
        out = {}
        for name in NodeState._fields:
            if self.slabs is None:
                a = np.zeros((0, self.d, self.d, self.b),
                             np.float32 if name == "w" else np.int32)
            else:
                a = getattr(self.slabs, name)[: self.n].to(
                    "cpu", copy=True).numpy()
            out[name] = a if name == "w" else a.view(np.uint32)
        return out

    def device_view(self) -> NodeState:
        """The full-capacity slabs (live tensors, no copy) for probes."""
        return self.slabs
