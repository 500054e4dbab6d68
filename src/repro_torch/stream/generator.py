"""Synthetic graph-stream generators (numpy copies of the reference's
``repro.stream.generator``; the same seed gives the same stream).

* ``lkml_like_stream``: small stream shaped like the Lkml reply network
  (communication graph, seconds resolution).
* ``wiki_talk_like_stream``: Wikipedia-talk-shaped: very high vertex
  count, sparse repetition (the paper's Wiki-talk dataset has 7,833,140
  edges).
"""
from __future__ import annotations

import numpy as np


def _zipf_vertices(rng, n, n_vertices, alpha):
    """Zipf(alpha) over a permuted vertex id space."""
    ranks = np.arange(1, n_vertices + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    perm = rng.permutation(n_vertices).astype(np.uint32)
    return perm[rng.choice(n_vertices, size=n, p=probs)]


def lkml_like_stream(n_edges: int = 50_000, seed: int = 3):
    """Communication-network-shaped stream: reply chains with heavy-tailed
    user activity over a multi-year span at 1-second slices."""
    rng = np.random.default_rng(seed)
    n_users = max(64, n_edges // 17)     # Lkml ratio |E|/|V| ~ 17
    src = _zipf_vertices(rng, n_edges, n_users, 1.8)
    dst = _zipf_vertices(rng, n_edges, n_users, 1.8)
    # replies cluster: 60% of edges reply to a recent thread (reuse dst)
    reply = rng.random(n_edges) < 0.6
    shift = rng.integers(1, 50, n_edges)
    idx = np.maximum(np.arange(n_edges) - shift, 0)
    dst = np.where(reply, src[idx], dst)
    w = np.ones(n_edges, np.float32)
    t = np.sort(rng.integers(0, 1 << 27, n_edges).astype(np.uint32))
    return src, dst.astype(np.uint32), w, t


def wiki_talk_like_stream(n_edges: int = 200_000, seed: int = 4):
    """Wikipedia-talk-shaped: very high vertex count, sparse repetition."""
    rng = np.random.default_rng(seed)
    n_users = n_edges // 8
    src = _zipf_vertices(rng, n_edges, n_users, 2.2)
    dst = _zipf_vertices(rng, n_edges, n_users, 2.2)
    w = np.ones(n_edges, np.float32)
    t = np.sort(rng.integers(0, 1 << 29, n_edges).astype(np.uint32))
    return src, dst, w, t
