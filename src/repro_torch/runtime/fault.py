"""Fault handling: preemption and straggler mitigation (port of
``repro.runtime.fault``).

Each host runs a :class:`PreemptionGuard`: SIGTERM from the scheduler
requests a graceful stop, and the resumable stream pipeline then takes a
final snapshot before returning.  :class:`StragglerMonitor` tracks
per-host step latencies so a coordinator can evict hosts whose rolling
median exceeds k times the fleet's.  On one host the mechanisms run
degenerate (one host), but the tests exercise the full control flow.
"""
from __future__ import annotations

import signal
from collections import defaultdict, deque
from typing import TYPE_CHECKING, Callable, Optional

if TYPE_CHECKING:
    from repro_torch.stream.pipeline import StreamPipeline


class PreemptionGuard:
    """Install SIGTERM/SIGINT hooks that request a graceful stop; the
    train loop checks ``should_stop`` each step and flushes a checkpoint.
    """

    def __init__(self, on_preempt: Optional[Callable[[], None]] = None,
                 install: bool = True):
        self._stop = False
        self._on_preempt = on_preempt
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM,):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:        # non-main thread (tests)
                    pass

    def _handler(self, signum, frame):
        self._stop = True
        if self._on_preempt:
            self._on_preempt()

    def request_stop(self) -> None:       # programmatic (tests / RPC)
        self._handler(None, None)

    @property
    def should_stop(self) -> bool:
        return self._stop

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


def run_with_preemption(pipeline: "StreamPipeline", sketch,
                        ckpt_dir: str, every: int = 1,
                        keep: Optional[int] = None,
                        guard: Optional[PreemptionGuard] = None,
                        **kw):
    """Wire a :class:`PreemptionGuard` into crash-consistent ingestion.

    SIGTERM from the scheduler flips the guard; ``run_resumable`` then
    takes one final atomic sketch+cursor snapshot and returns cleanly.
    Re-invoking after the preemption (same ``ckpt_dir``) resumes from
    that snapshot and produces a sketch bit-identical to an
    uninterrupted run.  Pass an existing ``guard`` to drive the stop
    programmatically (tests / RPC via ``guard.request_stop``); by
    default one is installed on SIGTERM and restored afterwards.
    """
    own = guard is None
    if own:
        guard = PreemptionGuard()
    try:
        return pipeline.run_resumable(
            sketch, ckpt_dir, every=every, keep=keep,
            should_stop=lambda: guard.should_stop, **kw)
    finally:
        if own:
            guard.restore()


class StragglerMonitor:
    """Per-host step-latency tracking with k*median eviction policy.

    ``record(host, dt)`` after each step; ``stragglers()`` returns hosts
    whose rolling-median latency exceeds ``threshold`` x fleet median —
    the coordinator excludes them from the next data dispatch (their
    batch shards get re-balanced) and schedules a restart when the fleet
    shrinks past ``min_hosts_frac``.
    """

    def __init__(self, threshold: float = 2.0, window: int = 16,
                 min_hosts_frac: float = 0.75):
        self.threshold = threshold
        self.window = window
        self.min_hosts_frac = min_hosts_frac
        self._lat: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))
        self._evicted: set[str] = set()

    def record(self, host: str, step_seconds: float) -> None:
        if host not in self._evicted:
            self._lat[host].append(step_seconds)

    @staticmethod
    def _median(xs) -> float:
        xs = sorted(xs)
        n = len(xs)
        return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])

    def stragglers(self) -> list[str]:
        meds = {h: self._median(list(d)) for h, d in self._lat.items()
                if d and h not in self._evicted}
        if len(meds) < 2:
            return []
        fleet = self._median(list(meds.values()))
        return [h for h, m in meds.items() if m > self.threshold * fleet]

    def evict(self, host: str) -> None:
        self._evicted.add(host)

    def active_hosts(self) -> list[str]:
        return [h for h in self._lat if h not in self._evicted]

    def needs_elastic_restart(self) -> bool:
        total = len(self._lat)
        if total == 0:
            return False
        return len(self.active_hosts()) < self.min_hosts_frac * total

    def rebalanced_shards(self, n_shards: int) -> dict[str, list[int]]:
        """Re-assign data-shard ids over the surviving hosts."""
        hosts = sorted(self.active_hosts())
        out = {h: [] for h in hosts}
        for i in range(n_shards):
            out[hosts[i % len(hosts)]].append(i)
        return out
