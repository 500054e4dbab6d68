"""PyTorch/CUDA port of the HIGGS graph-stream summary.

A package beside the JAX reference ``repro``: it imports ``torch`` and
numpy only, never ``jax`` or ``repro``.  Its sketch keeps the level pools
on a torch device and runs hand-written CUDA kernels for the leaf insert
(K1/K2) and the probes (K3/K4); on CPU tensors the same entry points run
the kernels' plain torch versions.  ``HiggsSketch(params)`` defaults to
the CUDA device and raises without one.
"""
from repro_torch.api.queries import (EdgeQuery, PathQuery, QueryResult,
                                     QueryStats, SubgraphQuery, VertexQuery)
from repro_torch.convert import sketch_from_reference_state
from repro_torch.core.higgs import HiggsSketch
from repro_torch.core.params import HiggsParams, RetentionPolicy

__all__ = [
    "EdgeQuery", "HiggsParams", "HiggsSketch", "PathQuery", "QueryResult",
    "QueryStats", "RetentionPolicy", "SubgraphQuery", "VertexQuery",
    "sketch_from_reference_state",
]
