"""Configuration for the HIGGS sketch (verbatim copy of the reference
``repro.core.params``, kept here so the port never imports ``repro``).

Defaults follow the paper's experimental setup (Sec. VI-A): d1 = 16,
F1 = 19, b = 3 entries per bucket, r = 4 mapping addresses per vertex
(=> 16 mapping buckets per edge), theta = 4 children per node (R = 1
fingerprint bit shifted into the address per level and side).
"""
from __future__ import annotations

import dataclasses
import math
import os


def _env_flag(name: str, default: bool) -> bool:
    """Boolean from the environment; unset/empty keeps the default.
    Lets CI matrix over engine defaults (e.g. ``HIGGS_BATCHED_INGEST=0``
    runs the whole suite on the legacy reference path) without touching
    call sites."""
    val = os.environ.get(name)
    if val is None or val.strip() == "":
        return default
    return val.strip().lower() not in ("0", "false", "off", "no")


@dataclasses.dataclass(frozen=True)
class RetentionPolicy:
    """Temporal lifecycle policy for the sketch's segment store.

    * ``none`` — the sketch grows monotonically (the original behavior).
    * ``window(t_horizon)`` — sealed segments whose newest timestamp has
      fallen more than ``t_horizon`` behind the newest closed leaf are
      evicted wholesale (leaf slab, ancestor closure, overflow keys,
      interval keys).  In-window answers are bit-identical to a fresh
      sketch built over the retained suffix alone.
    * ``budget(max_bytes)`` — whenever ``space_bytes()`` exceeds the
      budget, the oldest fine segment is *coarsened* first (its leaves
      and mid-level nodes collapse into the retained segment-root node,
      so the range stays answerable at segment resolution, one-sided);
      only when every old segment is already coarse are coarse roots
      evicted, oldest first.
    """

    kind: str = "none"          # "none" | "window" | "budget"
    t_horizon: int = 0          # window length in stream-timestamp units
    max_bytes: float = 0.0      # resident-space budget (paper accounting)

    def __post_init__(self) -> None:
        if self.kind not in ("none", "window", "budget"):
            raise ValueError(f"retention kind must be 'none', 'window', "
                             f"or 'budget', got {self.kind!r}")
        if self.kind == "window" and self.t_horizon <= 0:
            raise ValueError("window retention needs t_horizon > 0")
        if self.kind == "budget" and self.max_bytes <= 0:
            raise ValueError("budget retention needs max_bytes > 0")

    @classmethod
    def window(cls, t_horizon: int) -> "RetentionPolicy":
        return cls(kind="window", t_horizon=int(t_horizon))

    @classmethod
    def budget(cls, max_bytes: float) -> "RetentionPolicy":
        return cls(kind="budget", max_bytes=float(max_bytes))

    @classmethod
    def coerce(cls, value) -> "RetentionPolicy":
        """Accepts a policy, a snapshot dict, or a string shorthand
        (``"none"``, ``"window:3600"``, ``"budget:1048576"``) — the last
        two so CLIs and env-driven configs can select a policy without
        constructing the dataclass."""
        if isinstance(value, cls):
            return value
        if value is None:
            return cls()
        if isinstance(value, dict):
            return cls(**value)
        if isinstance(value, str):
            kind, _, arg = value.partition(":")
            kind = kind.strip().lower()
            if kind == "none":
                return cls()
            if kind == "window":
                return cls.window(int(arg))
            if kind == "budget":
                return cls.budget(float(arg))
            raise ValueError(f"cannot parse retention policy {value!r}")
        raise TypeError(f"cannot coerce {type(value).__name__} "
                        f"to RetentionPolicy")

    @property
    def active(self) -> bool:
        return self.kind != "none"


@dataclasses.dataclass(frozen=True)
class HiggsParams:
    d1: int = 16            # leaf compressed-matrix side length (power of two)
    F1: int = 19            # leaf fingerprint length in bits
    b: int = 3              # entries per bucket
    r: int = 4              # mapping addresses per vertex (MMB); r*r buckets/edge
    theta: int = 4          # max children per node; must be a power of four
    chunk_fill: float = 0.85  # target fill fraction of a leaf per chunk
    seed: int = 0x9E3779B9  # hash seed
    use_mmb: bool = True    # multiple-mapping-buckets optimization
    use_ob: bool = True     # overflow blocks (lossless spill)
    entry_bytes: float = 0.0  # space accounting override; 0 => computed
    batched_ingest: bool = dataclasses.field(
        default_factory=lambda: _env_flag("HIGGS_BATCHED_INGEST", True))
    #                             # multi-leaf batched drain (False = the
    #                             # per-leaf reference path; the default
    #                             # honors HIGGS_BATCHED_INGEST so CI can
    #                             # matrix both engines)
    insert_backend: str = "auto"  # "auto" -> "host" on CPU backends,
    #                               "vector" on TPU.  "vector" = vmapped
    #                               device placement, "host" = numpy
    #                               placement with the same phases,
    #                               "pallas" = sequential Alg.-1 kernel
    interpret: bool | None = None   # Pallas interpret mode; None = auto
    #                                 (compile on TPU, interpret elsewhere)
    pool_storage: str = "auto"    # level-pool slab storage: "host" =
    #                               numpy (CPU default, bit reference),
    #                               "device" = persistent jax slabs,
    #                               "auto" -> "device" for the pallas
    #                               backend (fused drain), else "host"
    retention: RetentionPolicy = RetentionPolicy()
    #                             # temporal lifecycle policy; accepts a
    #                             # RetentionPolicy, a dict (snapshot
    #                             # round trip), or a "window:3600" /
    #                             # "budget:1e6" string shorthand
    segment_levels: int = 2       # L: a sealed segment spans theta^L
    #                             # leaves and owns its full ancestor
    #                             # closure up to one level-(L+1) root;
    #                             # only consulted when retention.active

    def __post_init__(self) -> None:
        object.__setattr__(self, "retention",
                           RetentionPolicy.coerce(self.retention))
        if self.segment_levels < 1:
            raise ValueError("segment_levels must be >= 1")
        if self.d1 & (self.d1 - 1):
            raise ValueError("d1 must be a power of two")
        root = round(math.sqrt(self.theta))
        if root * root != self.theta or root & (root - 1):
            raise ValueError("theta must be a power of four")
        if self.F1 <= 0 or self.b <= 0 or self.r <= 0:
            raise ValueError("F1, b, r must be positive")
        if self.insert_backend not in ("auto", "vector", "host", "pallas"):
            raise ValueError("insert_backend must be 'auto', 'vector', "
                             "'host', or 'pallas'")
        if self.pool_storage not in ("auto", "host", "device"):
            raise ValueError("pool_storage must be 'auto', 'host', or "
                             "'device'")
        if self.insert_backend == "pallas" and not (self.use_ob and
                                                    self.batched_ingest):
            raise ValueError("the pallas insert backend requires use_ob "
                             "and batched_ingest (spills must go to "
                             "overflow blocks, not recursive leaves)")
        if self.retention.active and self.segment_levels + 1 > self.max_levels:
            raise ValueError(
                f"segment_levels={self.segment_levels} needs "
                f"{self.segment_levels + 1} tree levels but the "
                f"fingerprint budget allows only {self.max_levels}")

    @property
    def R(self) -> int:
        """Fingerprint bits shifted into the address per aggregation level."""
        return int(math.log2(math.sqrt(self.theta)))

    def d(self, level: int) -> int:
        """Matrix side length at 1-based tree level."""
        return self.d1 * (1 << (self.R * (level - 1)))

    def F(self, level: int) -> int:
        """Fingerprint length in bits at 1-based tree level."""
        f = self.F1 - self.R * (level - 1)
        if f <= 0:
            raise ValueError(f"fingerprint exhausted at level {level}")
        return f

    @property
    def max_levels(self) -> int:
        return (self.F1 - 1) // max(self.R, 1) + 1

    @property
    def leaf_capacity(self) -> int:
        """Entries a leaf matrix can hold."""
        return self.b * self.d1 * self.d1

    @property
    def chunk_size(self) -> int:
        """Stream items routed to one leaf (item-based leaf sizing)."""
        return max(1, int(self.leaf_capacity * self.chunk_fill))

    def leaf_entry_bits(self) -> int:
        """Bits per leaf entry: two fingerprints + weight + timestamp offset
        + MMB index pair (2 * ceil(log2 r)), per the paper's layout."""
        idx_bits = 2 * max(1, math.ceil(math.log2(max(self.r, 2))))
        return 2 * self.F1 + 32 + 32 + (idx_bits if self.use_mmb else 0)

    def node_entry_bits(self, level: int) -> int:
        """Bits per non-leaf entry at a given level (no timestamp)."""
        idx_bits = 2 * max(1, math.ceil(math.log2(max(self.r, 2))))
        return 2 * self.F(level) + 32 + (idx_bits if self.use_mmb else 0)

    @property
    def fp_mask(self) -> int:
        return (1 << self.F1) - 1


DEFAULT_PARAMS = HiggsParams()
