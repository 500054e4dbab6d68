"""KONECT-format loader (port of ``repro.stream.loader``): the paper's
Lkml / Wikipedia-talk / StackOverflow datasets are distributed in this
format, ``src dst [weight [timestamp]]`` per line with '%' comments."""
from __future__ import annotations

import gzip
import os

import numpy as np

from repro_torch.stream import generator


def load_konect(path: str, max_edges: int | None = None):
    """Returns (src, dst, w, t) sorted by timestamp, rebased to 0."""
    opener = gzip.open if path.endswith(".gz") else open
    srcs, dsts, ws, ts = [], [], [], []
    with opener(path, "rt") as fh:
        for line in fh:
            if line.startswith(("%", "#")) or not line.strip():
                continue
            parts = line.split()
            srcs.append(int(parts[0]))
            dsts.append(int(parts[1]))
            ws.append(float(parts[2]) if len(parts) > 2 else 1.0)
            ts.append(int(float(parts[3])) if len(parts) > 3 else len(ts))
            if max_edges and len(srcs) >= max_edges:
                break
    src = np.asarray(srcs, np.uint32)
    dst = np.asarray(dsts, np.uint32)
    w = np.asarray(ws, np.float32)
    t = np.asarray(ts, np.uint64)
    order = np.argsort(t, kind="stable")
    t = t[order]
    t -= t[0]                                    # rebase to 0
    return src[order], dst[order], w[order], t.astype(np.uint32)


def dataset_or_synthetic(name: str, n_edges: int, data_dir: str = "data"):
    """Load a KONECT dataset if present under ``data_dir``, else fall back
    to the shaped synthetic twin (nothing is downloaded)."""
    candidates = [os.path.join(data_dir, f"{name}{ext}")
                  for ext in (".tsv", ".tsv.gz", ".txt", ".txt.gz")]
    for c in candidates:
        if os.path.exists(c):
            return load_konect(c, max_edges=n_edges)
    synth = {
        "lkml": generator.lkml_like_stream,
        "wiki-talk": generator.wiki_talk_like_stream,
    }.get(name)
    if synth is None:
        return generator.power_law_stream(n_edges=n_edges, seed=5)
    return synth(n_edges)
