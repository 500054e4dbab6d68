"""Fault handling for long-running ingest: preemption and stragglers."""
from repro_torch.runtime.fault import (PreemptionGuard, StragglerMonitor,
                                       run_with_preemption)

__all__ = ["PreemptionGuard", "StragglerMonitor", "run_with_preemption"]
