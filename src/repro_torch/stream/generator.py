"""Synthetic graph-stream generators (numpy copies of the reference's
``repro.stream.generator``; the same seed gives the same stream).

* ``power_law_stream``: skewed vertex-degree streams (power-law exponent
  1.5 - 3.0, paper Fig. 14) with bursty arrivals.
* ``variance_stream``: controls the arrival-rate variance (paper Fig. 15)
  via bursty per-slot arrival counts.
* ``lkml_like_stream``: small stream shaped like the Lkml reply network
  (communication graph, seconds resolution).
* ``balanced_stream``: near-uniform vertex activity (many lightly active
  tenants).
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


def power_law_stream(n_edges: int = 100_000, n_vertices: int = 10_000,
                     skew: float = 2.0, t_max: int = 1 << 20,
                     seed: int = 0, burstiness: float = 1.0):
    """Returns (src, dst, w, t) with power-law degrees and bursty arrivals."""
    rng = np.random.default_rng(seed)
    src = _zipf_vertices(rng, n_edges, n_vertices, skew)
    dst = _zipf_vertices(rng, n_edges, n_vertices, skew)
    w = rng.integers(1, 16, n_edges).astype(np.float32)
    # non-homogeneous arrivals: gamma-distributed inter-arrival gaps
    gaps = rng.gamma(shape=1.0 / burstiness, scale=burstiness,
                     size=n_edges)
    t = np.cumsum(gaps)
    t = (t / t[-1] * (t_max - 1)).astype(np.uint32)
    return src, dst, w, t


def variance_stream(n_edges: int = 100_000, n_vertices: int = 10_000,
                    variance: float = 600.0, t_slots: int = 4096,
                    seed: int = 0):
    """Streams whose per-slot arrival counts have a chosen variance
    (paper Fig. 15: variance 600 - 1600, mean fixed)."""
    rng = np.random.default_rng(seed)
    mean = n_edges / t_slots
    # negative binomial: mean m, variance m + m^2/r  => r from target var
    excess = max(variance - mean, 1e-6)
    r_param = mean * mean / excess
    counts = rng.negative_binomial(r_param, r_param / (r_param + mean),
                                   t_slots)
    diff = n_edges - counts.sum()
    # adjust to exact edge count, keeping non-negativity
    while diff != 0:
        i = rng.integers(0, t_slots)
        step = 1 if diff > 0 else -1
        if counts[i] + step >= 0:
            counts[i] += step
            diff -= step
    t = np.repeat(np.arange(t_slots, dtype=np.uint32), counts)
    src = _zipf_vertices(rng, n_edges, n_vertices, 2.0)
    dst = _zipf_vertices(rng, n_edges, n_vertices, 2.0)
    w = rng.integers(1, 16, n_edges).astype(np.float32)
    return src, dst, w, t


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


def balanced_stream(n_edges: int = 100_000, n_vertices: int = 50_000,
                    t_max: int = 1 << 20, seed: int = 5):
    """Near-uniform vertex activity — the scale-out benchmark workload.

    Source-vertex hash partitioning (sharding) balances shards
    only as well as the stream's per-source mass is spread: a stream
    like Lkml, where one sender emits ~half the edges, pins that mass
    to one shard no matter the shard count.  This generator models the
    many-tenant serving shape (millions of lightly active vertices)
    where partition parallelism is the right tool, so shard-speedup
    numbers measure the engine rather than the workload's skew.
    """
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges).astype(np.uint32)
    dst = rng.integers(0, n_vertices, n_edges).astype(np.uint32)
    w = rng.integers(1, 16, n_edges).astype(np.float32)
    t = np.sort(rng.integers(0, t_max, n_edges).astype(np.uint32))
    return src, dst, w, t


def wiki_talk_like_stream(n_edges: int = 200_000, seed: int = 4):
    """Wikipedia-talk-shaped: very high vertex count, sparse repetition."""
    rng = np.random.default_rng(seed)
    n_users = n_edges // 8
    src = _zipf_vertices(rng, n_edges, n_users, 2.2)
    dst = _zipf_vertices(rng, n_edges, n_users, 2.2)
    w = np.ones(n_edges, np.float32)
    t = np.sort(rng.integers(0, 1 << 29, n_edges).astype(np.uint32))
    return src, dst, w, t
