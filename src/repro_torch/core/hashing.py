"""Vertex hashing: 32-bit mix, fingerprint/address split, LCG address chains.

Port of ``repro.core.hashing``.  The paper (Eq. 1) splits a vertex hash
H(v) into an F1-bit fingerprint (low bits) and an address (high bits,
mod d1):

    f(v) = H(v) & (2^F1 - 1)         h(v) = (H(v) >> F1) % d1

The MMB optimization (Sec. IV-C) derives r candidate addresses per vertex
with a linear-congruential chain.  With d a power of two and (a % 4 == 1,
c odd) the chain has full period, so the r candidate rows of one vertex are
pairwise distinct for r <= d.

Torch has no full ``uint32`` arithmetic on the CPU (no ``>>``, ``+`` or
``%``), so the torch functions carry 32-bit values as ``int64`` tensors
in ``[0, 2**32)`` and mask after every step that could carry past bit
31.  The ``np_*`` twins keep numpy ``uint32`` arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B
_LCG_A = 5   # a % 4 == 1
_LCG_C = 1   # odd
MASK32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit value of any integer tensor, as ``int64``
    (``int32`` bit patterns map to ``[0, 2**32)``)."""
    return x.to(torch.int64) & MASK32


def mix32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """32-bit finalizer-style hash (bit-exact twin of the reference)."""
    x = as_u32(x) ^ (seed & MASK32)
    x = x ^ (x >> 16)
    x = (x * _MIX1) & MASK32
    x = x ^ (x >> 15)
    x = (x * _MIX2) & MASK32
    x = x ^ (x >> 16)
    return x


def fingerprint(h: torch.Tensor, F: int) -> torch.Tensor:
    """Low-F-bit fingerprint of hash values."""
    return h & ((1 << F) - 1)


def address(h: torch.Tensor, F: int, d: int) -> torch.Tensor:
    """Base address: high bits of the hash, mod matrix side d."""
    return (h >> F) % d


def lcg_chain(addr0: torch.Tensor, r: int, d: int) -> torch.Tensor:
    """Stack of r candidate addresses, shape (..., r); chain[0] == addr0."""
    addrs = [addr0.to(torch.int64)]
    for _ in range(r - 1):
        addrs.append(((addrs[-1] * _LCG_A + _LCG_C) & MASK32) % d)
    return torch.stack(addrs, dim=-1)


def shift_up(fp: torch.Tensor, addr: torch.Tensor, R: int, F_child: int):
    """Alg. 2 shift: move the top R fingerprint bits into the address.

    Returns (fp_parent, addr_parent) for one side of an edge when a child
    entry at (addr, fp) is re-bucketed into the parent matrix.
    """
    top = fp >> (F_child - R)
    fp_p = fp & ((1 << (F_child - R)) - 1)
    addr_p = ((addr << R) | top) & MASK32
    return fp_p, addr_p


def level_fp_addr(hashes: torch.Tensor, F1: int, d1: int, level: int,
                  R: int):
    """Fingerprint/base-address of raw hashes directly at a given level
    (``shift_up`` applied ``level - 1`` times to the leaf split)."""
    F = F1 - R * (level - 1)
    d = d1 << (R * (level - 1))
    return fingerprint(hashes, F), address(hashes, F, d)


def np_mix32(x: np.ndarray, seed: int) -> np.ndarray:
    """NumPy twin of :func:`mix32` (host-side re-hash of spilled items
    and query coordinates)."""
    x = np.asarray(x, np.uint32)
    x = x ^ np.uint32(seed & MASK32)
    x = x ^ (x >> 16)
    x = (x * np.uint32(_MIX1)).astype(np.uint32)
    x = x ^ (x >> 15)
    x = (x * np.uint32(_MIX2)).astype(np.uint32)
    x = x ^ (x >> 16)
    return x


def np_lcg_chain(addr0: np.ndarray, r: int, d: int) -> np.ndarray:
    addrs = [np.asarray(addr0, np.uint64)]
    for _ in range(r - 1):
        addrs.append((addrs[-1] * _LCG_A + _LCG_C) % d)
    return np.stack(addrs, axis=-1).astype(np.uint32)
