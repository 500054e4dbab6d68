"""Snapshots on disk in the reference's manifest + npz layout."""
from repro_torch.checkpoint.store import (gc_checkpoints, latest_step,
                                          load_snapshot, read_manifest,
                                          restore_arrays, save_checkpoint)

__all__ = ["save_checkpoint", "restore_arrays", "read_manifest",
           "load_snapshot", "latest_step", "gc_checkpoints"]
