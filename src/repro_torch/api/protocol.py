"""Snapshot surface of the port's summaries (the ``SnapshotMixin`` of
``repro.api.protocol``; the rest of that module is ROADMAP.md module
item 11)."""
from __future__ import annotations

from repro_torch.checkpoint.store import load_snapshot, save_checkpoint


class SnapshotMixin:
    """Default ``save``/``restore`` over the ``state_dict``/``load_state``
    pair.

    A summary implements:

    * ``snapshot_kind``: its registry name, recorded in the manifest;
    * ``state_dict() -> (arrays, meta)``: a flat ``{key: np.ndarray}``
      dict of its full state plus a JSON-able ``meta`` dict whose
      ``meta["config"]`` holds the constructor params;
    * ``load_state(arrays, meta)``: the exact inverse, leaving a summary
      bit-identical to the saved one (same answers, same ``space_bytes``,
      same future-insert behaviour), window state included.

    ``save`` writes one atomic snapshot (tmp dir + rename, one manifest),
    so a preemption mid-save never corrupts an existing one.
    """

    snapshot_kind: str

    def state_dict(self):
        raise NotImplementedError

    def load_state(self, arrays: dict, meta: dict) -> None:
        raise NotImplementedError

    def save(self, directory: str, step: int) -> str:
        arrays, meta = self.state_dict()
        return save_checkpoint(directory, step, arrays,
                               metadata={"summary": self.snapshot_kind,
                                         "state": meta})

    def restore(self, directory: str, step: int | None = None) -> None:
        arrays, metadata, _ = load_snapshot(directory, step,
                                            expect_kind=self.snapshot_kind)
        self.load_state(arrays, metadata["state"])
