"""Chunked, resumable stream pipeline (port of ``repro.stream.pipeline``).

Feeds a sketch in fixed batches with a persistable cursor, so ingestion
can resume after preemption (see ``repro_torch.runtime``).  Snapshots go
through the port's checkpoint store in the reference's layout.
"""
from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING, Callable, Iterator

import numpy as np

from repro_torch.checkpoint.store import (gc_checkpoints, latest_step,
                                          load_snapshot, save_checkpoint)

if TYPE_CHECKING:
    from repro_torch.core.higgs import HiggsSketch


class StreamPipeline:
    def __init__(self, src, dst, w, t, batch: int = 8192):
        self.arrays = (np.asarray(src), np.asarray(dst),
                       np.asarray(w), np.asarray(t))
        self.batch = batch
        self.cursor = 0

    def __len__(self) -> int:
        return len(self.arrays[0])

    def _iter_batches(self, batch: int) -> Iterator[tuple]:
        n = len(self)
        while self.cursor < n:
            sl = slice(self.cursor, min(self.cursor + batch, n))
            # advance BEFORE yielding so a checkpointed cursor never
            # replays a batch already handed out
            self.cursor = sl.stop
            yield tuple(a[sl] for a in self.arrays)

    def __iter__(self) -> Iterator[tuple]:
        return self._iter_batches(self.batch)

    def feed(self, sketch: "HiggsSketch",
             progress: Callable[[int], None] | None = None,
             flush: bool = True, align: bool = True,
             on_retention: Callable[[int, dict], None] | None = None
             ) -> None:
        """Feed every remaining batch into a sketch.

        With ``align`` (default), the batch size is rounded to a whole
        number of the sketch's leaves (``params.chunk_size``), so each
        ``insert`` hands the batched ingestion engine only complete
        leaves — one multi-leaf drain per call, no partial-leaf carry.
        The final sketch is identical either way (leaf boundaries depend
        only on the item sequence); alignment just batches better.

        ``on_retention(cursor, stats)`` is the temporal-lifecycle hook:
        after each batch it receives the sketch's ``retention_stats()``
        (eviction/coarsening counters, resident bytes), so callers can
        chart memory plateaus or alert on unexpected eviction without
        polling the sketch themselves.  Ignored for summaries that have
        no lifecycle (no ``retention_stats`` attribute).
        """
        batch = self._aligned_batch(sketch, align)
        stats_fn = getattr(sketch, "retention_stats", None) \
            if on_retention is not None else None
        for b in self._iter_batches(batch):
            sketch.insert(*b)
            if progress:
                progress(self.cursor)
            if stats_fn is not None:
                on_retention(self.cursor, stats_fn())
        if flush:
            sketch.flush()
            if stats_fn is not None:
                on_retention(self.cursor, stats_fn())

    def feed_steps(self, sketch: "HiggsSketch",
                   align: bool = True) -> Iterator[int]:
        """Incremental :meth:`feed`: insert one batch per step and yield
        the advanced cursor, leaving flush/quiesce decisions to the
        caller.  This is the writer-side surface a concurrent serving
        layer drives (ROADMAP.md module item 12) — it
        interleaves ingestion steps with epoch pins and must know exactly
        which stream prefix each pinned epoch covers, which is what the
        yielded cursor records."""
        batch = self._aligned_batch(sketch, align)
        for b in self._iter_batches(batch):
            sketch.insert(*b)
            yield self.cursor

    # -- fault tolerance ------------------------------------------------
    def save_cursor(self, path: str) -> None:
        """Atomically persist {cursor, batch}: write a sibling tmp file
        and ``os.replace`` it in, so a preemption mid-dump can never leave
        a truncated cursor file (which would defeat the checkpoint)."""
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            json.dump({"cursor": self.cursor, "batch": self.batch}, fh)
        os.replace(tmp, path)

    def restore_cursor(self, path: str) -> None:
        """Restore both cursor AND batch size.  The batch governs where
        future cursors can land; silently keeping a different local
        ``batch`` made resumed runs checkpoint at positions the original
        schedule could never produce.

        A missing file is a normal first run (no-op); a corrupt or
        incomplete one raises — silently restarting from cursor 0 would
        double-ingest the whole prefix into the sketch.
        """
        if not os.path.exists(path):
            return
        try:
            with open(path) as fh:
                meta = json.load(fh)
            cursor = int(meta["cursor"])
            batch = int(meta.get("batch", self.batch))
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            raise ValueError(
                f"corrupt cursor file {path!r}: {e}; refusing to reset "
                f"silently — delete it to restart from scratch") from e
        self.cursor = cursor
        self.batch = batch

    def _aligned_batch(self, sketch: "HiggsSketch", align: bool) -> int:
        chunk = getattr(getattr(sketch, "params", None), "chunk_size", 0)
        if align and chunk:
            return max(chunk, self.batch // chunk * chunk)
        return self.batch

    def snapshot(self, sketch: "HiggsSketch", ckpt_dir: str) -> str:
        """Snapshot sketch + cursor as ONE atomic unit.

        Both live in a single manifest (one tmp-dir rename), so a crash
        can never persist a cursor that disagrees with the sketch state —
        the failure mode that made a resumed run silently replay or skip
        stream items.  The step is the cursor itself (monotone and unique
        per schedule position).
        """
        arrays, meta = sketch.state_dict()
        metadata = {
            "summary": getattr(sketch, "snapshot_kind", sketch.name),
            "state": meta,
            "cursor": {"cursor": int(self.cursor), "batch": int(self.batch)},
        }
        return save_checkpoint(ckpt_dir, int(self.cursor), arrays, metadata)

    def restore_snapshot(self, sketch: "HiggsSketch", ckpt_dir: str,
                         step: int | None = None) -> int:
        """Rebuild ``sketch`` and this pipeline's cursor from the latest
        (or a specific) snapshot; returns the restored step."""
        kind = getattr(sketch, "snapshot_kind", sketch.name)
        arrays, metadata, step = load_snapshot(ckpt_dir, step,
                                               expect_kind=kind)
        if "cursor" not in metadata:
            raise ValueError(f"snapshot step {step} under {ckpt_dir!r} has "
                             f"no cursor — not a pipeline snapshot")
        sketch.load_state(arrays, metadata["state"])
        cur = metadata["cursor"]
        self.cursor = int(cur["cursor"])
        self.batch = int(cur["batch"])
        return step

    def run_resumable(self, sketch: "HiggsSketch", ckpt_dir: str,
                      every: int = 1,
                      progress: Callable[[int], None] | None = None,
                      flush: bool = True, align: bool = True,
                      should_stop: Callable[[], bool] | None = None,
                      keep: int | None = None,
                      resume: bool = True,
                      on_retention: Callable[[int, dict], None] | None = None
                      ) -> "HiggsSketch":
        """Crash-consistent :meth:`feed`: snapshot sketch + cursor every
        ``every`` batches, resuming from the newest snapshot if one
        exists.  Lifecycle state (segment records, eviction counters,
        window bases) rides inside the sketch's own ``state_dict``, so a
        resumed run continues retention bit-identically; ``on_retention``
        is the same per-batch hook as :meth:`feed`.

        Because each snapshot captures the sketch's *entire* state —
        including the pending not-yet-a-leaf buffer — a killed run
        restored from its last snapshot continues into a sketch
        bit-identical to one fed without interruption.  ``should_stop``
        (e.g. a :class:`~repro_torch.runtime.fault.PreemptionGuard`) is checked
        after every batch; on stop a final snapshot is taken before
        returning, un-flushed, so the next invocation resumes mid-stream.
        ``keep`` bounds retained snapshots via
        :func:`~repro_torch.checkpoint.store.gc_checkpoints`.
        """
        if every < 1:
            raise ValueError("run_resumable needs every >= 1")
        if resume and latest_step(ckpt_dir) is not None:
            self.restore_snapshot(sketch, ckpt_dir)
        batch = self._aligned_batch(sketch, align)
        stats_fn = getattr(sketch, "retention_stats", None) \
            if on_retention is not None else None
        done = 0
        for b in self._iter_batches(batch):
            sketch.insert(*b)
            done += 1
            if progress:
                progress(self.cursor)
            if stats_fn is not None:
                on_retention(self.cursor, stats_fn())
            if done % every == 0:
                self.snapshot(sketch, ckpt_dir)
                if keep:
                    gc_checkpoints(ckpt_dir, keep=keep)
            if should_stop and should_stop():
                if done % every:
                    self.snapshot(sketch, ckpt_dir)
                return sketch
        if flush:
            sketch.flush()
            if stats_fn is not None:
                # flush can seal + evict; the hook must see the final
                # lifecycle state, exactly as feed() reports it
                on_retention(self.cursor, stats_fn())
        # final snapshot holds the flushed sketch at cursor == len(self),
        # so a restart of a completed run restores and immediately returns
        self.snapshot(sketch, ckpt_dir)
        if keep:
            gc_checkpoints(ckpt_dir, keep=keep)
        return sketch
