"""Step-granular snapshots on disk (jax-free port of
``repro.checkpoint.store``; the layout is the reference's, so each package
reads the other's snapshots).

Layout: <dir>/step_<N>/
  manifest.json   — keys, dtypes and shapes of the arrays, step, metadata
  arrays.npz      — the arrays, named a0, a1, ... in sorted key order

The port saves flat ``{key: np.ndarray}`` dicts (a sketch's
``state_dict()``), stored in sorted key order as the reference's pytree
flattening stores a dict.  Writes are atomic (tmp dir + rename) so a
preemption mid-write never corrupts the latest snapshot; stale
``.tmp_step_*`` directories left behind by a crash mid-save are swept on
the next ``save_checkpoint``.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np


def _sweep_stale_tmp(directory: str) -> None:
    """Remove ``.tmp_step_*`` leftovers from saves that died mid-write."""
    if not os.path.isdir(directory):
        return
    for d in os.listdir(directory):
        if d.startswith(".tmp_step_"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def _storable(leaf) -> np.ndarray:
    a = np.asarray(leaf)
    # exotic float dtypes (bfloat16, fp8) are not npz-portable; store as
    # float32 (lossless upcast), restore casts back
    if a.dtype.kind == "V" or a.dtype.name not in np.sctypeDict:
        return a.astype(np.float32)
    return a


def save_checkpoint(directory: str, step: int, arrays: dict,
                    metadata=None) -> str:
    """Write ``arrays`` (a flat ``{key: array}`` dict) and ``metadata`` as
    step ``step`` under ``directory``; returns the step's directory."""
    keys = sorted(arrays)
    leaves = [np.asarray(arrays[k]) for k in keys]
    _sweep_stale_tmp(directory)
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": _storable(leaf) for i, leaf in enumerate(leaves)})
    manifest = {
        "step": step,
        "keys": keys,
        "dtypes": [str(leaf.dtype) for leaf in leaves],
        "shapes": [list(leaf.shape) for leaf in leaves],
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def gc_checkpoints(directory: str, keep: int = 3) -> list[int]:
    """Retention: delete all but the newest ``keep`` step directories
    (and any stale tmp dirs); returns the steps removed."""
    if keep < 1:
        raise ValueError("gc_checkpoints needs keep >= 1")
    if not os.path.isdir(directory):
        return []
    _sweep_stale_tmp(directory)
    steps = sorted(int(d.split("_", 1)[1]) for d in os.listdir(directory)
                   if d.startswith("step_"))
    victims = steps[:-keep]
    for s in victims:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)
    return victims


def read_manifest(directory: str, step: int) -> dict:
    """The manifest alone (step, keys, dtypes/shapes, metadata)."""
    path = os.path.join(directory, f"step_{step}", "manifest.json")
    with open(path) as fh:
        return json.load(fh)


def restore_arrays(directory: str, step: int):
    """Restore a flat ``{key: np.ndarray}`` dict; shapes come from the
    snapshot itself and the manifest's dtypes recover upcast exotic
    floats.  Returns ``(arrays, metadata)``."""
    manifest = read_manifest(directory, step)
    data = np.load(os.path.join(directory, f"step_{step}", "arrays.npz"))
    arrays = {}
    for i, (key, dtype) in enumerate(zip(manifest["keys"],
                                         manifest["dtypes"])):
        arrays[key] = data[f"a{i}"].astype(np.dtype(dtype), copy=False)
    return arrays, manifest["metadata"]


def load_snapshot(directory: str, step: int | None = None,
                  expect_kind: str | None = None):
    """Load a *summary* snapshot: ``(arrays, metadata, step)``.

    ``step=None`` resolves to the newest snapshot; the metadata must
    carry a summary kind and state, and ``expect_kind`` (when given) must
    match.  Shared by ``SnapshotMixin.restore`` and the stream pipeline's
    resume path so the two cannot drift.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no snapshots under {directory!r}")
    arrays, metadata = restore_arrays(directory, step)
    kind = metadata.get("summary")
    if kind is None or "state" not in metadata:
        raise ValueError(f"step {step} under {directory!r} is not a "
                         f"summary snapshot (no summary/state metadata)")
    if expect_kind is not None and kind != expect_kind:
        raise ValueError(
            f"snapshot step {step} under {directory!r} holds a {kind!r} "
            f"summary, not {expect_kind!r}")
    return arrays, metadata, step
