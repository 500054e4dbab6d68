#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the four hand-written CUDA kernels from ``src/repro_torch/
kernels/csrc`` (into ``build/kernels/``), then:

1. drives the port's main path at the paper's Wiki-talk scale: a
   7,833,140-edge ``wiki_talk_like_stream`` goes through ``insert`` /
   ``flush`` with the default ``HiggsParams`` (d1=16, F1=19, b=3, r=4,
   theta=4), then 4096 edge, 4096 vertex-out and 4096 vertex-in queries
   are answered at three ranges (full span, 1/16, 1/256).  Every
   estimate must be at least the exact answer (HIGGS's one-sided error),
   which numpy computes from the stream;
2. holds each kernel against its plain torch version on the card at the
   shapes of that run (K1 at one real drain's leaf count, K2 at one leaf,
   K3/K4 at every tree level with 4096 queries, both directions and time
   modes, and K4 once more with all queries on 64 hot vertices):
   bit-exact pools and spill masks, exact probe sums (integer weights);
   then times each kernel back to back (``b2b_ms``: a group of launches
   enqueued behind a sleep kernel, so the wrappers' host work is off the
   device's clock), with a cold L2 (``cold_ms``: each launch timed on its
   own after a read of a buffer five times the L2's size), and for one
   call; and measures the dependent round trips that bound K1's
   sequential item chain (``tools/chain_bench.cu``, built here);
   K3 also as the planner launches it, once over all the entries of an
   edge batch: every level without the time filter in one launch, every
   level with it in another, and the main path's own three edge batches
   (timed as K3 calls, and as whole ``_edge_batch`` calls, overflow-block
   scans included); and K4 once more at b = 1024 (a bucket wider than its
   staging chunk), exact against its plain version;
3. ingests a 1.1M-edge prefix twice, once through the kernels and once
   through the plain versions (``kernels=False``), and requires equal
   pools, overflow blocks and answers;
4. runs the windowed deployment: the whole stream into a sketch with a
   2^27 window (a quarter of its time span), queries inside the retained
   window, and a fresh sketch on the retained suffix that must hold the
   same leaf index, non-empty pools and answers (``windowed``); the same
   run through ``StreamPipeline.run_resumable``, stopped by a
   ``PreemptionGuard`` after batch 17 and resumed from its snapshot by a
   new sketch, which must equal the uninterrupted one bit for bit
   (``resume``); the 1.1M prefix under a byte budget of half its
   unbounded space, checked after every insert (``budget``); and a d1 =
   64, b = 3 sketch, whose leaves do not fit a block's shared memory, so
   K1 runs its global-memory form: one drain held against the plain
   version and timed, then 2^20 edges answered (``large leaf``).

To compare two commits, run this same script from a checkout of each:
it times whichever kernels the checkout it sits in holds.

The counts of kernel launches are set to 0 just before the main path and
read just after it, and likewise around the windowed and the large-leaf
sketch runs.  The line before the last is the card's name and
power limit, the one before it a JSON summary of the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result line, without a GPU, outside a checkout, or if any phase fails.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_EDGES = 7_833_140          # SNAP wiki-talk-temporal
STREAM_SEED = 4
BATCH = 1 << 18              # edges per insert call
Q = 4096                     # queries per (kind, range)
PREFIX = 1_100_000           # kernels-vs-plain end-to-end prefix
HBM_BYTES_PER_S = 3.35e12    # H100 SXM peak (NVIDIA data sheet)
B2B_N = 20                   # launches per back-to-back group
B2B_GROUPS = 5
B2B_SLEEP_MS = 8.0           # device sleep that covers a group's enqueue
L2_FLUSH_BYTES = 256 << 20   # read before each cold launch (L2: 50 MB)
CHAIN_ITERS = 1 << 20        # round trips of the chain microbenchmark
HOT_VERTICES = 64            # the shared-lines phase: queries on <= 64
WINDOW = 1 << 27             # windowed phase: a quarter of the time span
RESUME_EVERY = 8             # resume phase: a snapshot every 8 batches,
RESUME_KEEP = 2              # the newest 2 kept, and a stop after
RESUME_STOP_AFTER = 17       # batch 17
LARGE_D1, LARGE_B = 64, 3    # large-leaf phase: 240 KB of slots per leaf
LARGE_EDGES = 1 << 20
DEVICE = "cuda"
REPO = Path(__file__).resolve().parent
OUT = REPO / "chiprun_out"
CHAIN_SRC = REPO / "tools" / "chain_bench.cu"


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def one_call_ms(torch, fn, reps: int, setup=None) -> float:
    """Median time of one call of ``fn`` (CUDA events around the call, so
    the wrapper's host work counts, as it does on the main path; ``setup``
    runs outside the timed window)."""
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


SLEEP = {}                   # calibrated torch.cuda._sleep: cycles per ms
FLUSH = {}                   # the buffer cold_ms reads between launches


def calibrate_sleep(torch) -> None:
    cycles = 1 << 22
    torch.cuda._sleep(cycles)                  # warm-up
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    SLEEP["cycles_per_ms"] = cycles / a.elapsed_time(b)


def b2b_ms(torch, fn, prepare=None, n: int = B2B_N, groups: int = B2B_GROUPS):
    """Device time per launch of ``n`` launches back to back: after a
    warm-up, a sleep kernel holds the stream while the host enqueues one
    event, the ``n`` calls and a second event, so the host's wrapper work
    overlaps the device's and no launch waits on the host.  Median over
    ``groups`` groups.  ``prepare(i)`` returns the arguments of launch i
    (for in-place kernels, a fresh copy); all are made before the first
    event.  Returns (ms, covered): ``covered`` says the host finished
    enqueuing every group before the sleep ended."""
    args = prepare(0) if prepare is not None else ()
    fn(*args)
    torch.cuda.synchronize()
    times, covered = [], True
    sleep_ms = B2B_SLEEP_MS
    for _ in range(groups):
        args = [prepare(i) if prepare is not None else () for i in range(n)]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(sleep_ms * SLEEP["cycles_per_ms"]))
        h0 = time.perf_counter()
        a.record()
        for x in args:
            fn(*x)
        b.record()
        host_ms = (time.perf_counter() - h0) * 1e3
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
        covered &= host_ms < sleep_ms
    return float(np.median(times)), covered


def cold_ms(torch, fn, prepare=None, n: int = B2B_N, groups: int = 2):
    """Device time of one launch with a cold L2: behind a sleep kernel, the
    host enqueues, for each of ``n`` launches, a read of a buffer of
    ``L2_FLUSH_BYTES`` (outside the timed window), an event, the call and
    an event.  Median over ``groups * n`` launches; arguments as in
    :func:`b2b_ms`.  Returns (ms, covered)."""
    if "buf" not in FLUSH:
        FLUSH["buf"] = torch.ones(L2_FLUSH_BYTES // 4, device=DEVICE)
    flush = FLUSH["buf"]
    args = prepare(0) if prepare is not None else ()
    fn(*args)
    torch.cuda.synchronize()
    times, covered = [], True
    for _ in range(groups):
        args = [prepare(i) if prepare is not None else () for i in range(n)]
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        torch.cuda.synchronize()
        torch.cuda._sleep(int(B2B_SLEEP_MS * SLEEP["cycles_per_ms"]))
        h0 = time.perf_counter()
        for (a, b), x in zip(evs, args):
            flush.sum()
            a.record()
            fn(*x)
            b.record()
        host_ms = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        times += [a.elapsed_time(b) for a, b in evs]
        covered &= host_ms < B2B_SLEEP_MS
    return float(np.median(times)), covered


def reset_counts(kmods) -> None:
    for fn in kmods:
        fn.launches = 0
        if hasattr(fn, "global_launches"):     # K1/K2's global-memory form
            fn.global_launches = 0


# ---------------------------------------------------------------------------
# exact answers (numpy): sort by (key, t), prefix sums of the weights
# ---------------------------------------------------------------------------

class ExactSums:
    """Exact range sums of ``w`` per key over the stream."""

    def __init__(self, keys: np.ndarray, t: np.ndarray, w: np.ndarray):
        order = np.lexsort((t, keys))
        self.keys = keys[order]
        grp = np.concatenate([[0], np.cumsum(self.keys[1:] !=
                                             self.keys[:-1])])
        self.grp = grp.astype(np.int64)
        self.comp = (self.grp << 32) | t[order].astype(np.int64)
        self.cw = np.concatenate([[0.0], np.cumsum(w[order], dtype=np.float64)])

    def __call__(self, qkeys: np.ndarray, ts: int, te: int) -> np.ndarray:
        pos = np.minimum(np.searchsorted(self.keys, qkeys), len(self.keys) - 1)
        hit = self.keys[pos] == qkeys
        g = self.grp[pos]
        lo = np.searchsorted(self.comp, (g << 32) | ts, "left")
        hi = np.searchsorted(self.comp, (g << 32) | te, "right")
        return np.where(hit, self.cw[hi] - self.cw[lo], 0.0)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def make_queries(stream, n_users, rng):
    src, dst = stream[0], stream[1]
    pick = rng.integers(0, len(src), Q // 2)
    e_src = np.concatenate([src[pick], rng.integers(0, n_users, Q // 2)
                            .astype(np.uint32)])
    e_dst = np.concatenate([dst[pick], rng.integers(0, n_users, Q // 2)
                            .astype(np.uint32)])
    v_out = np.concatenate([src[rng.integers(0, len(src), Q // 2)],
                            rng.integers(0, n_users, Q // 2).astype(np.uint32)])
    v_in = np.concatenate([dst[rng.integers(0, len(dst), Q // 2)],
                           rng.integers(0, n_users, Q // 2).astype(np.uint32)])
    return e_src, e_dst, v_out, v_in


def ranges_of(t: np.ndarray):
    t0, t1 = int(t[0]), int(t[-1])
    span, mid = t1 - t0, (t0 + t1) // 2
    return {"full": (t0, t1),
            "1/16": (mid - span // 32, mid + span // 32),
            "1/256": (mid - span // 512, mid + span // 512)}


def answer_all(sk, api, queries, ranges):
    """Edge, out and in queries at every range: ``{(kind, range):
    (estimates, stats)}`` and the seconds spent in ``query``."""
    _, _, EdgeQuery, VertexQuery = api
    e_src, e_dst, v_out, v_in = queries
    results, secs = {}, 0.0
    for name, (ts, te) in ranges.items():
        for kind, q in (("edge", EdgeQuery(e_src, e_dst, ts, te)),
                        ("out", VertexQuery(v_out, ts, te, "out")),
                        ("in", VertexQuery(v_in, ts, te, "in"))):
            t0 = time.perf_counter()
            res = sk.query([q])
            secs += time.perf_counter() - t0
            results[(kind, name)] = (np.asarray(res.values[0]), res.stats)
    return results, secs


def ingest(sk, stream, n):
    for lo in range(0, n, BATCH):
        sk.insert(*(a[lo:min(lo + BATCH, n)] for a in stream))
    sk.flush()


def time_cascade(sk) -> dict:
    """Wall seconds of the aggregation cascade per parent level, summed
    over the run (each step ends on a device-to-host copy of its spill
    mask, so the host clock covers its device work)."""
    secs: dict[int, float] = {}
    build = sk._build_parents_fused

    def timed(level, u0, m):
        t0 = time.perf_counter()
        build(level, u0, m)
        secs[level + 1] = secs.get(level + 1, 0.0) + time.perf_counter() - t0

    sk._build_parents_fused = timed
    return secs


def capture_first_drain(sk, captured: dict) -> None:
    """Keep a copy of the K1 inputs of the sketch's first drain (fresh
    leaves, as the drain has them) in ``captured``."""
    insert = sk._pipeline._insert

    def capture(nodes, *items, r):
        if "items" not in captured:
            captured["items"] = [x.clone() for x in items]
            captured["shape"] = tuple(nodes.fp_s.shape)
            captured["r"] = r
        return insert(nodes, *items, r=r)

    sk._pipeline._insert = capture


def main_path(torch, api, stream, queries, counted):
    """The measured run: counts 0 -> ingest -> queries -> counts read."""
    HiggsSketch, HiggsParams, _, _ = api
    sk = HiggsSketch(HiggsParams())                 # default device: CUDA
    captured = {"edge_batches": [], "cascade_s": time_cascade(sk)}
    probe_levels = sk.planner._edge_probe_levels

    def capture_edge_batch(entries, *leaf, params):
        captured["edge_batches"].append((entries, leaf))   # one per range
        return probe_levels(entries, *leaf, params=params)

    sk.planner._edge_probe_levels = capture_edge_batch
    capture_first_drain(sk, captured)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counted)
    t0 = time.perf_counter()
    ingest(sk, stream, N_EDGES)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    results, q_s = answer_all(sk, api, queries, ranges_of(stream[3]))
    launches = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated()
    sk.planner._edge_probe_levels = probe_levels
    return sk, captured, results, launches, ingest_s, q_s, peak


def check_answers(stream, queries, results, ranges=None):
    """Every estimate >= the exact answer over ``stream`` (HIGGS's
    one-sided error) at ``ranges`` (default: the stream's own three);
    returns the ARE per (kind, range)."""
    src, dst, w, t = stream
    ranges = ranges or ranges_of(t)
    u64 = np.uint64
    exact = {
        "edge": ExactSums((src.astype(u64) << u64(32)) | dst, t, w),
        "out": ExactSums(src.astype(u64), t, w),
        "in": ExactSums(dst.astype(u64), t, w),
    }
    e_src, e_dst, v_out, v_in = queries
    qkeys = {"edge": (e_src.astype(u64) << u64(32)) | e_dst,
             "out": v_out.astype(u64), "in": v_in.astype(u64)}
    are = {}
    for (kind, name), (est, _) in results.items():
        ts, te = ranges[name]
        ex = exact[kind](qkeys[kind], ts, te)
        require(est.shape == qkeys[kind].shape and np.isfinite(est).all(),
                f"{kind}/{name}: bad estimate array")
        low = np.nonzero(est < ex)[0]
        require(len(low) == 0, f"{kind}/{name}: {len(low)} estimates below "
                f"the exact answer (first {low[:5]})")
        pos = ex > 0
        are[f"{kind}/{name}"] = (float(np.mean((est[pos] - ex[pos]) /
                                               ex[pos])) if pos.any()
                                 else None, int(pos.sum()))
    return are


def start_chain_build():
    """Start ``nvcc`` on ``tools/chain_bench.cu`` (beside the kernels'
    builds); returns (library path, process or None if already built)."""
    import hashlib

    from repro_torch.kernels import _build
    tag = hashlib.sha1(CHAIN_SRC.read_bytes()).hexdigest()[:12]
    lib = _build.BUILD_DIR.parent / "tools" / f"chain_bench-{tag}.so"
    if lib.exists():
        return lib, None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                             str(tmp), str(CHAIN_SRC)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return lib, (tmp, proc)


def chain_bench(torch, lib_path, build) -> dict:
    """The dependent round trips that bound K1's item chain, on one warp:
    mode 0 is a shared-memory read, a ballot and a shared-memory write of
    the word the next read takes; mode 1 a ballot, a find-first-set and a
    shuffle, the chain of ``leaf_insert_kernel``.  ns and SM cycles per
    round trip, and the SM clock they imply."""
    import ctypes

    from repro_torch.kernels import _build
    if build is not None:
        tmp, proc = build
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"tools/chain_bench.cu did not "
                f"build:\n{log}")
        os.replace(tmp, lib_path)
    fn = ctypes.CDLL(str(lib_path)).chain_bench
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(2, dtype=torch.int64, device=DEVICE)
    res = {}
    for mode, name in ((0, "smem_ballot_smem"), (1, "ballot_shfl")):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(mode, 1024, out.data_ptr(), stream), "chain_bench")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        _build.check(fn(mode, CHAIN_ITERS, out.data_ptr(), stream),
                     "chain_bench")
        b.record()
        b.synchronize()
        ns = a.elapsed_time(b) * 1e6 / CHAIN_ITERS
        cyc = int(out[0]) / CHAIN_ITERS
        res[name] = dict(ns=ns, cycles=cyc, sm_mhz=cyc / ns * 1e3)
        print(f"chain round trip {name}: {ns:.2f} ns = {cyc:.1f} SM cycles "
              f"(SM clock {cyc / ns * 1e3:.0f} MHz)", flush=True)
    return res


def l2_bench(torch, lib_path) -> dict:
    """Read rates of the card (``l2_read_bench`` in
    ``tools/chain_bench.cu``, every SM at full occupancy, loads through
    the L2 only): a coalesced stream of 16-byte loads over 16 MiB (L2
    resident) and over 1 GiB (HBM), and 4-byte loads of random 32-byte
    sectors of 16 MiB, eight in flight per thread, counted as whole
    sectors.  TB/s over one timed launch after a warm-up."""
    import ctypes

    from repro_torch.kernels import _build
    fn = ctypes.CDLL(str(lib_path)).l2_read_bench
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    res = {}
    for name, mode, nbytes, reps in (("stream_l2_16MiB", 0, 16 << 20, 256),
                                     ("stream_hbm_1GiB", 0, 1 << 30, 2),
                                     ("sectors_l2_16MiB", 1, 16 << 20, 1024)):
        buf = torch.ones(nbytes // 4, dtype=torch.int32, device=DEVICE)
        stream = torch.cuda.current_stream().cuda_stream
        grid = sms * 8                          # 8 CTAs of 256 threads

        def launch():
            _build.check(fn(mode, buf.data_ptr(), nbytes, reps, grid,
                            out.data_ptr(), stream), "l2_read_bench")

        launch()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        launch()
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b)
        moved = (nbytes * reps if mode == 0
                 else grid * 256 * reps * 32)   # whole sectors
        res[name] = dict(ms=ms, bytes=moved, tb_s=moved / ms / 1e9)
        print(f"read rate {name}: {moved / ms / 1e9:.3f} TB/s ({moved} "
              f"bytes in {ms:.4f} ms)", flush=True)
        del buf
    return res


def k1_k2_phase(torch, tcm, li, captured, chain):
    """K1 on the inputs of the main path's first drain (fresh leaves, as
    the drain had them), K2 on its first leaf: bit-exact against the
    plain versions, then timed back to back and cold (a fresh copy of the
    matrices per launch) and for one call."""
    L, d, _, b = captured["shape"]
    r = captured["r"]
    items = captured["items"]
    n = items[0].shape[1]
    dev = items[0].device

    def batched():
        return tcm.make_nodes(L, d, b, dev)

    def one_leaf():
        return tcm.NodeState(*(x[0] for x in tcm.make_nodes(1, d, b, dev)))

    out = {}
    for name, L_, its, fresh, kern, plain in (
            ("leaf_insert_batched", L, items, batched,
             li.leaf_insert_batched, li.leaf_insert_batched_plain),
            ("leaf_insert", 1, [x[0] for x in items], one_leaf,
             li.leaf_insert, li.leaf_insert_plain)):
        kn, ks = kern(fresh(), *its, r=r)
        pn, ps = plain(fresh(), *its, r=r)
        torch.cuda.synchronize()
        for f, a, c in zip(kn._fields, kn, pn):
            require(torch.equal(a, c), f"{name}: field {f} differs from "
                    f"the plain version")
        require(torch.equal(ks, ps), f"{name}: spill mask differs")
        err = float((kn.w - pn.w).abs().max())
        box = {}

        def setup(fresh=fresh):
            box["nodes"] = fresh()

        def launch(nodes, kern=kern):
            kern(nodes, *its, r=r)

        ms, covered = b2b_ms(torch, launch, lambda i, f=fresh: (f(),))
        cold, cov2 = cold_ms(torch, launch, lambda i, f=fresh: (f(),))
        covered &= cov2
        one = one_call_ms(torch, lambda: kern(box["nodes"], *its, r=r), 10,
                          setup=setup)
        plain_ms = one_call_ms(torch, lambda: plain(box["nodes"], *its,
                                                    r=r), 2, setup=setup)
        cells = L_ * d * d * b
        nbytes = (L_ * n * (4 * 4 + 1 + 2 * 4 * r + 4)   # items in, spill out
                  + 2 * cells * 20)                      # matrices in + out
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        # items of a leaf are sequential: n dependent round trips at least,
        # each a ballot, a find-first-set and a shuffle in this kernel
        chain_ms = n * chain["ballot_shfl"]["ns"] * 1e-6
        smem_ms = n * chain["smem_ballot_smem"]["ns"] * 1e-6
        out[name] = dict(L=L_, n=n, ms=ms, cold_ms=cold, one_call_ms=one,
                         covered=covered, plain_ms=plain_ms, bound_ms=bound,
                         chain_bound_ms=chain_ms, smem_chain_ms=smem_ms,
                         max_abs_err=err, spilled=int(ks.sum()))
        print(f"phase {name}: L={L_} n={n} d={d} b={b} r={r} bit-exact vs "
              f"plain; kernel {ms:.4f} ms back to back, {cold:.4f} ms cold "
              f"(covered={covered}), one call {one:.4f} ms, plain "
              f"{plain_ms:.1f} ms, bound {bound:.4f} ms (bytes), chain "
              f"bound {chain_ms:.4f} ms (ballot-shuffle; {smem_ms:.4f} ms "
              f"with a shared-memory round trip per item), "
              f"{out[name]['spilled']} items spilled", flush=True)
    return out


def vertex_bound_ms(torch, idx, vrows, d, b):
    """The fingerprints of the distinct candidate lines (every one must be
    read to find the matches), the queries and the answers; the weights
    (and times) of the few matching slots are left out."""
    lines = (idx.to(torch.int64)[None, :, None] * d
             + vrows.to(torch.int64)[:, None, :])
    q, r = vrows.shape
    nbytes = (int(torch.unique(lines).numel()) * d * b * 4
              + q * (4 + 4 * r) + len(idx) * 5 + q * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def new_sums():
    return dict(ms=0.0, cold_ms=0.0, one_call_ms=0.0, plain_ms=0.0,
                bound_ms=0.0, max_abs_err=0.0, covered=True)


def add_to(tot, **v):
    for k, x in v.items():
        if k == "covered":
            tot[k] = tot[k] and x
        elif x is not None:
            tot[k] += x


def timed_probe(torch, new, plain, tag, bound, tot):
    """Back to back, cold, one call, plain; printed and added to
    ``tot``."""
    ms, covered = b2b_ms(torch, new)
    cold, cov2 = cold_ms(torch, new)
    covered &= cov2
    one = one_call_ms(torch, new, 10)
    plain_ms = one_call_ms(torch, plain, 2)
    print(f"phase {tag}: exact vs plain; kernel {ms:.4f} ms back to back, "
          f"{cold:.4f} ms cold (covered={covered}), one call {one:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms", flush=True)
    row = dict(ms=ms, cold_ms=cold, one_call_ms=one, plain_ms=plain_ms,
               bound_ms=bound, covered=covered)
    if tot is not None:
        add_to(tot, **row)
    return row


def level_ids(pool) -> np.ndarray:
    """Up to 6 global node ids spread over a level pool (a plan probes
    at most 2 * (theta - 1) = 6 nodes per level at the default theta)."""
    return np.unique(np.linspace(0, pool.n - 1, min(pool.n, 6))
                     .astype(np.int64)) + pool.base


def time_bounds(sk):
    t = sk.leaf_ends
    return int(t[len(t) // 3]), int(t[2 * len(t) // 3])


def probe_phase(torch, tcm, pr, sk, queries):
    p = sk.params
    e_src, e_dst, v_out, v_in = queries
    dev = sk.device

    def coords(vid, side, level):
        f1, base = sk._query_coords(vid, side)
        fp, rows = tcm.coords_at_level(
            torch.from_numpy(f1.astype(np.int64)).to(dev),
            torch.from_numpy(base.astype(np.int64)).to(dev), level, p)
        return fp.to(torch.int32), rows.to(torch.int32)

    ts_mid, te_mid = time_bounds(sk)
    tot = {k: new_sums() for k in ("edge_probe", "vertex_probe",
                                   "edge_probe_time", "vertex_probe_time")}
    levels = []
    for level in range(1, sk.n_levels + 1):
        pool = sk.pools[level - 1]
        ids = level_ids(pool)
        idx, mask = pool.gather_ids(ids)
        slabs = pool.device_view()
        m, d, b, r = len(ids), p.d(level), p.b, p.r
        fs, rows = coords(e_src, "s", level)
        fd, cols = coords(e_dst, "d", level)
        # entries above level 1 carry t = 0: a filter from 0 keeps them
        lo = ts_mid if level == 1 else 0
        for match_time, (ts, te) in ((False, (0, 0xFFFFFFFF)),
                                     (True, (lo, te_mid))):
            sfx = "_time" if match_time else ""
            args = (slabs, idx, mask, fs, fd, rows, cols, ts, te)
            got = pr.edge_probe(*args, match_time=match_time)
            want = pr.edge_probe_plain(*args, match_time=match_time)
            require(torch.equal(got, want), f"edge_probe L{level} "
                    f"match_time={match_time}: differs from plain")
            slot_bytes, _, _ = edge_slot_bytes(torch, slabs, idx, mask, fs,
                                               fd, rows, cols, match_time)
            nbytes = slot_bytes + Q * (8 + 8 * r) + m * 5 + Q * 4
            kw = dict(match_time=match_time)
            row = timed_probe(
                torch, lambda: pr.edge_probe(*args, **kw),
                lambda: pr.edge_probe_plain(*args, **kw),
                f"edge_probe L{level} d={d} m={m} q={Q} match_time="
                f"{match_time} ({int((got > 0).sum())} nonzero)",
                nbytes / HBM_BYTES_PER_S * 1e3, tot["edge_probe" + sfx])
            levels.append(dict(kernel="edge_probe", level=level, d=d, m=m,
                               match_time=match_time, **row))
            for direction, vid, side in (("out", v_out, "s"),
                                         ("in", v_in, "d")):
                fv, vrows = coords(vid, side, level)
                vargs = (slabs, idx, mask, fv, vrows, ts, te)
                kw = dict(direction=direction, match_time=match_time)
                got = pr.vertex_probe(*vargs, **kw)
                want = pr.vertex_probe_plain(*vargs, **kw)
                require(torch.equal(got, want), f"vertex_probe L{level} "
                        f"{direction} match_time={match_time}: differs")
                row = timed_probe(
                    torch, lambda: pr.vertex_probe(*vargs, **kw),
                    lambda: pr.vertex_probe_plain(*vargs, **kw),
                    f"vertex_probe L{level} {direction} d={d} m={m} q={Q} "
                    f"match_time={match_time}",
                    vertex_bound_ms(torch, idx, vrows, d, b),
                    tot["vertex_probe" + sfx])
                levels.append(dict(kernel="vertex_probe", level=level, d=d,
                                   m=m, direction=direction,
                                   match_time=match_time, **row))
    return tot, levels


def edge_slot_bytes(torch, slabs, idx, mask, fs, fd, rows, cols,
                    match_time):
    """Slab bytes K3 must read for one entry, at its level's coordinates:
    fp_s of every distinct candidate slot of the unmasked matrices, fp_d
    of the distinct slots whose fp_s equals a querying fingerprint, and w
    (and t, with the time filter) of the distinct slots matching both,
    as this run's data has them.  Also the bytes of the 32-byte sectors
    that the kernel's loads touch, counted per query (a sector shared by
    two queries counts twice; the L1 may serve the second), for fp_s
    alone and for all the fields it loads."""
    i64 = torch.int64
    d, b = slabs.fp_s.shape[1], slabs.fp_s.shape[3]
    live = idx.to(i64)[mask.to(torch.bool)]
    bucket = ((live[None, :, None, None] * d
               + rows.to(i64)[:, None, :, None]) * d
              + cols.to(i64)[:, None, None, :])          # (q, m, r, r)
    slot = bucket[..., None] * b + torch.arange(b, device=bucket.device)

    def field(f):
        return f.reshape(-1)[slot].to(i64) & 0xFFFFFFFF

    def u32(x):
        return (x.to(i64) & 0xFFFFFFFF)[:, None, None, None, None]

    def sectors(sel):                   # distinct (query, sector) pairs
        qi = torch.arange(slot.shape[0], device=slot.device)
        key = qi[:, None, None, None, None] * (slabs.fp_s.numel() // 8 + 1) \
            + slot // 8
        return 32 * int(torch.unique(key[sel]).numel())

    hit_s = field(slabs.fp_s) == u32(fs)
    hit = hit_s & (field(slabs.fp_d) == u32(fd))
    nbytes = (4 * int(torch.unique(slot).numel())
              + 4 * int(torch.unique(slot[hit_s]).numel())
              + (8 if match_time else 4) * int(torch.unique(slot[hit])
                                               .numel()))
    fp_s_sectors = sectors(torch.ones_like(hit))
    all_sectors = (fp_s_sectors + sectors(hit_s)
                   + (2 if match_time else 1) * sectors(hit))
    return nbytes, fp_s_sectors, all_sectors


def edge_levels_bound_ms(torch, tcm, p, entries, leaf):
    """Bytes of one K3 launch over ``entries`` (:func:`edge_slot_bytes`
    of each entry, the leaf-level queries once, the matrices' idx/mask
    and the answers) as ms at the HBM rate, and the sector bytes of its
    fp_s loads and of all its slab loads."""
    f1s, rows1, f1d, cols1 = leaf
    q, r = rows1.shape
    nbytes = q * (8 + 8 * r) + q * 4 * len(entries)
    sector_bytes = load_sector_bytes = 0
    for e in entries:
        fs, rows = tcm.level_coords(f1s, rows1, e.level, p)
        fd, cols = tcm.level_coords(f1d, cols1, e.level, p)
        dev = f1s.device
        slot_bytes, fp_s_sectors, all_sectors = edge_slot_bytes(
            torch, e.slabs, torch.as_tensor(e.idx, device=dev),
            torch.as_tensor(e.mask, device=dev), fs, fd, rows, cols,
            e.match_time)
        nbytes += slot_bytes + len(e.idx) * 5
        sector_bytes += fp_s_sectors
        load_sector_bytes += all_sectors
    return nbytes / HBM_BYTES_PER_S * 1e3, sector_bytes, load_sector_bytes


def edge_levels_phase(torch, tcm, pr, sk, queries, captured, stream):
    """K3 as the planner launches it, one launch over many entries: (a)
    the probe phase's entries of every level, without and with the time
    filter, each list as one launch; (b) the main path's three edge
    batches as captured (the plan's levels, then the filtered leaves),
    timed as K3 calls and as whole ``_edge_batch`` calls.  Exact against
    ``edge_probe_levels_plain``."""
    from repro_torch.api.queries import QueryStats

    p = sk.params
    dev = sk.device
    e_src, e_dst = queries[0], queries[1]
    f1s, bs = sk._query_coords(e_src, "s")
    f1d, bd = sk._query_coords(e_dst, "d")

    def to_dev(a):
        return torch.from_numpy(a.astype(np.int64)).to(dev)

    i32 = torch.int32
    leaf = (to_dev(f1s).to(i32), tcm.chain_from_base(to_dev(bs), p.r,
                                                     p.d1).to(i32),
            to_dev(f1d).to(i32), tcm.chain_from_base(to_dev(bd), p.r,
                                                     p.d1).to(i32))
    ts_mid, te_mid = time_bounds(sk)
    rows = {}

    def measure(tag, entries, leaf):
        got = pr.edge_probe_levels(entries, *leaf, params=p)
        want = pr.edge_probe_levels_plain(entries, *leaf, params=p)
        require(torch.equal(got, want), f"edge_probe_levels {tag}: differs "
                f"from plain")
        bound, sector_bytes, load_sectors = edge_levels_bound_ms(
            torch, tcm, p, entries, leaf)
        row = timed_probe(
            torch, lambda: pr.edge_probe_levels(entries, *leaf, params=p),
            lambda: pr.edge_probe_levels_plain(entries, *leaf, params=p),
            f"edge_probe_levels {tag}: {len(entries)} entries in one launch, "
            f"levels {[e.level for e in entries]}, sectors: fp_s "
            f"{sector_bytes} bytes, all loads {load_sectors} bytes", bound,
            None)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        row.update(entries=len(entries), max_abs_err=err,
                   nonzero=int((got > 0).sum()), sector_bytes=sector_bytes,
                   load_sector_bytes=load_sectors)
        rows[tag] = row

    plain_entries = None                          # no time filter
    for match_time in (False, True):
        entries = []
        for level in range(1, sk.n_levels + 1):
            pool = sk.pools[level - 1]
            ids = level_ids(pool)
            lo = ts_mid if level == 1 else 0      # as in the probe phase
            ts, te = (lo, te_mid) if match_time else (0, 0xFFFFFFFF)
            entries.append(pr.EdgeEntry(
                pool.device_view(), pool.slots_of(ids),
                np.ones(len(ids), bool), level, ts, te, match_time))
        measure("all levels" + (", time filter" if match_time else ""),
                entries, leaf)
        plain_entries = plain_entries or entries
    sweep = edge_levels_sweep(torch, pr, p, plain_entries, leaf)
    for name, (entries, batch_leaf) in zip(ranges_of(stream[3]),
                                           captured["edge_batches"]):
        measure(f"main path {name}", entries, batch_leaf)
        ts, te = ranges_of(stream[3])[name]
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            sk.planner._edge_batch(e_src, e_dst, ts, te, QueryStats())
            secs.append(time.perf_counter() - t0)
        rows[f"main path {name}"]["edge_batch_ms"] = float(
            np.median(secs) * 1e3)
        print(f"phase planner edge batch {name}: {np.median(secs) * 1e3:.2f} "
              f"ms per _edge_batch call ({Q} queries, overflow-block scans "
              f"included)", flush=True)
    return rows, sweep


def edge_levels_sweep(torch, pr, p, entries, leaf):
    """What the all-level K3 launch's time follows: back to back and cold
    over the first k entries (k = 1..n, levels from the leaves up), and
    over all entries with the first q/4 and q/2 queries."""
    out = []

    def one(tag, ents, lf):
        def fn():
            pr.edge_probe_levels(ents, *lf, params=p)
        ms, covered = b2b_ms(torch, fn)
        cold, cov2 = cold_ms(torch, fn)
        out.append(dict(tag=tag, entries=len(ents), q=lf[0].shape[0], ms=ms,
                        cold_ms=cold, covered=covered and cov2))
        print(f"sweep edge_probe_levels {tag}: {len(ents)} entries, "
              f"q={lf[0].shape[0]}: {ms:.4f} ms back to back, {cold:.4f} ms "
              f"cold (covered={covered and cov2})", flush=True)

    for k in range(1, len(entries) + 1):
        one(f"first {k} entries", entries[:k], leaf)
    for frac in (4, 2):
        n = leaf[0].shape[0] // frac
        one(f"q/{frac}", entries, tuple(x[:n] for x in leaf))
    return out


def wide_bucket_phase(torch, tcm, pr):
    """K4 at b = 1024, wider than its 768-slot staging chunk: random
    slabs (m = 2, d = 16), Q queries on fingerprints of their first
    candidate line, both directions and time modes, exact against the
    plain version."""
    rng = np.random.default_rng(31)
    m, d, b, r = 2, 16, 1024, 4
    shape = (m, d, d, b)
    occ = rng.random(shape) < 0.5
    fields = [np.where(occ, rng.integers(0, 1 << 12, shape), -1),
              np.where(occ, rng.integers(0, 1 << 12, shape), -1),
              np.where(occ, rng.integers(1, 100, shape), 0),
              rng.integers(0, 1000, shape), np.zeros(shape)]
    slabs = tcm.NodeState(*(torch.from_numpy(a.astype(
        np.float32 if i == 2 else np.int32)).to(DEVICE)
        for i, a in enumerate(fields)))
    idx = torch.arange(m, dtype=torch.int32, device=DEVICE)
    mask = torch.ones(m, dtype=torch.bool, device=DEVICE)
    base = torch.from_numpy(rng.integers(0, d, Q)).to(DEVICE)
    vrows = tcm.chain_from_base(base, r, d).to(torch.int32)
    out = {}
    for direction, f in (("out", 0), ("in", 1)):
        line = vrows[:, 0].long().cpu().numpy()
        x = rng.integers(0, d, Q)
        sl = rng.integers(0, b, Q)
        mi = rng.integers(0, m, Q)
        pos = (mi, line, x, sl) if direction == "out" else (mi, x, line, sl)
        fv = torch.from_numpy(fields[f][pos].astype(np.int32)).to(DEVICE)
        for match_time, (ts, te) in ((False, (0, 0xFFFFFFFF)),
                                     (True, (100, 700))):
            kw = dict(direction=direction, match_time=match_time)
            args = (slabs, idx, mask, fv, vrows, ts, te)
            got = pr.vertex_probe(*args, **kw)
            want = pr.vertex_probe_plain(*args, **kw)
            require(torch.equal(got, want), f"vertex_probe b={b} "
                    f"{direction} match_time={match_time}: differs")
            ms, covered = b2b_ms(torch, lambda: pr.vertex_probe(*args, **kw))
            out[f"{direction}{'_time' if match_time else ''}"] = dict(
                ms=ms, covered=covered, nonzero=int((got > 0).sum()))
            print(f"phase vertex_probe b={b} d={d} m={m} q={Q} {direction} "
                  f"match_time={match_time}: exact vs plain, {ms:.4f} ms "
                  f"back to back (covered={covered}), "
                  f"{int((got > 0).sum())} nonzero", flush=True)
    return out


def shared_lines_phase(torch, tcm, pr, sk, stream):
    """K4 with heavily shared lines: all Q queries fall on the stream's
    first HOT_VERTICES distinct sources ("out") or destinations ("in"),
    at every level, without the time filter."""
    p = sk.params
    dev = sk.device
    rng = np.random.default_rng(21)
    tot, levels = new_sums(), []
    for level in range(1, sk.n_levels + 1):
        pool = sk.pools[level - 1]
        idx, mask = pool.gather_ids(level_ids(pool))
        slabs = pool.device_view()
        d = p.d(level)
        for direction, col, side in (("out", 0, "s"), ("in", 1, "d")):
            hot = pd_unique(stream[col])[:HOT_VERTICES]
            vid = hot[rng.integers(0, len(hot), Q)]
            f1, base = sk._query_coords(vid, side)
            fv, vrows = tcm.coords_at_level(
                torch.from_numpy(f1.astype(np.int64)).to(dev),
                torch.from_numpy(base.astype(np.int64)).to(dev), level, p)
            fv, vrows = fv.to(torch.int32), vrows.to(torch.int32)
            vargs = (slabs, idx, mask, fv, vrows, 0, 0xFFFFFFFF)
            kw = dict(direction=direction, match_time=False)
            got = pr.vertex_probe(*vargs, **kw)
            want = pr.vertex_probe_plain(*vargs, **kw)
            require(torch.equal(got, want), f"shared lines: vertex_probe "
                    f"L{level} {direction} differs from plain")
            nlines = int(torch.unique(vrows).numel())
            row = timed_probe(
                torch, lambda: pr.vertex_probe(*vargs, **kw),
                lambda: pr.vertex_probe_plain(*vargs, **kw),
                f"vertex_probe shared lines L{level} {direction} d={d} "
                f"q={Q} on {len(hot)} vertices, {nlines} distinct lines",
                vertex_bound_ms(torch, idx, vrows, d, p.b), tot)
            levels.append(dict(level=level, d=d, direction=direction,
                               lines=nlines, **row))
    return tot, levels


def pd_unique(x: np.ndarray) -> np.ndarray:
    """Distinct values in order of first appearance."""
    _, first = np.unique(x, return_index=True)
    return x[np.sort(first)]


def prefix_phase(torch, api, stream, queries):
    HiggsSketch, HiggsParams, EdgeQuery, VertexQuery = api
    sks, secs = [], []
    for kernels in (True, False):
        sk = HiggsSketch(HiggsParams(), device=DEVICE, kernels=kernels)
        t0 = time.perf_counter()
        ingest(sk, stream, PREFIX)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        sks.append(sk)
    a, b = sks
    require([p.n for p in a.pools] == [p.n for p in b.pools],
            "prefix: pool sizes differ")
    for lvl, (pa, pb) in enumerate(zip(a.pools, b.pools), start=1):
        for f in ("fp_s", "fp_d", "w", "t", "idx"):
            require(np.array_equal(pa.arrs[f][:pa.n].view(np.uint32),
                                   pb.arrs[f][:pb.n].view(np.uint32)),
                    f"prefix: level {lvl} {f} differs")
    require(np.array_equal(a.leaf_ends, b.leaf_ends), "prefix: leaves differ")
    da, db = a.ob.data, b.ob.data
    require(list(da) == list(db), "prefix: overflow keys differ")
    for key in da:
        for f in da[key]:
            require(np.array_equal(da[key][f], db[key][f]),
                    f"prefix: overflow {key}/{f} differs")
    e_src, e_dst, v_out, v_in = (x[:1024] for x in queries)
    t = stream[3][:PREFIX]
    qs = []
    for ts, te in ranges_of(t).values():
        qs += [EdgeQuery(e_src, e_dst, ts, te),
               VertexQuery(v_out, ts, te, "out"),
               VertexQuery(v_in, ts, te, "in")]
    for x, y in zip(a.query(qs).values, b.query(qs).values):
        require(np.array_equal(x, y), "prefix: answers differ")
    print(f"phase prefix: {PREFIX} edges, kernels {secs[0]:.2f} s vs plain "
          f"{secs[1]:.2f} s: pools, overflow blocks and answers equal "
          f"({a.n_levels} levels, {a.ob.total_entries()} overflow entries, "
          f"space_bytes {a.space_bytes():.0f})", flush=True)
    return a.space_bytes()

# ---------------------------------------------------------------------------
# retention, snapshots and the resumable pipeline (windowed deployments)
# ---------------------------------------------------------------------------

def state_equal(a, b, what: str) -> None:
    """Every array of two sketches' ``state_dict()`` equal, bit for bit."""
    xa, _ = a.state_dict()
    xb, _ = b.state_dict()
    require(sorted(xa) == sorted(xb), f"{what}: state_dict keys differ")
    for k in xa:
        require(xa[k].dtype == xb[k].dtype and np.array_equal(
            xa[k].view(np.uint8), xb[k].view(np.uint8)),
            f"{what}: state_dict array {k} differs")


def nonempty_pools_equal(win, fresh, what: str) -> None:
    """The levels where the fresh suffix build holds nodes equal the
    windowed sketch's bit for bit; the windowed sketch holds none above
    them (it may keep a level whose nodes were all evicted)."""
    for lvl, pw in enumerate(win.pools, start=1):
        pf = fresh.pools[lvl - 1] if lvl <= len(fresh.pools) else None
        if pf is None or pf.n == 0:
            require(pw.n == 0, f"{what}: level {lvl} holds {pw.n} nodes, "
                    f"the fresh build none")
            continue
        require(pw.n == pf.n, f"{what}: level {lvl} holds {pw.n} nodes "
                f"against {pf.n}")
        xw, xf = pw.export(), pf.export()
        for f in xw:
            require(np.array_equal(xw[f].view(np.uint32),
                                   xf[f].view(np.uint32)),
                    f"{what}: level {lvl} {f} differs")


def fmt_secs(secs: dict) -> dict:
    return {k: round(v, 3) for k, v in sorted(secs.items())}


def pools_line(sk) -> str:
    return ", ".join(f"L{i}: {p.n} (base {p.base})"
                     for i, p in enumerate(sk.pools, start=1))


def windowed_phase(torch, api, stream, queries, counted):
    """The windowed deployment on the full stream: counts 0 -> ingest
    with a 2^27 window -> queries inside the retained window -> counts
    read; then a fresh sketch on the retained suffix must equal it."""
    HiggsSketch, HiggsParams, _, _ = api
    params = HiggsParams(retention=f"window:{WINDOW}")
    sk = HiggsSketch(params)
    cascade_s = time_cascade(sk)
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counted)
    t0 = time.perf_counter()
    ingest(sk, stream, N_EDGES)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    peak_ingest = torch.cuda.max_memory_allocated()
    lo, hi = int(sk.leaf_starts[0]), int(stream[3][-1])
    ranges = ranges_of(np.array([lo, hi]))
    results, q_s = answer_all(sk, api, queries, ranges)
    launches = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated() - base_bytes
    stats = sk.retention_stats()
    print(f"windowed: ingest {N_EDGES} edges in {ingest_s:.2f} s = "
          f"{N_EDGES / ingest_s:.0f} edges/s (window {WINDOW}); "
          f"{len(results) * Q} queries in {q_s:.2f} s; retention_stats "
          f"{stats}", flush=True)
    print(f"windowed: nodes per level {pools_line(sk)}, "
          f"{sk.ob.total_entries()} overflow entries, space_bytes "
          f"{sk.space_bytes():.0f}, max_memory_allocated {peak} ({peak_ingest} "
          f"by the end of ingest; {base_bytes} held before the phase, so "
          f"{peak - base_bytes} above it at the peak, {held} held by the "
          f"sketch after it); aggregation seconds per "
          f"parent level {fmt_secs(cascade_s)}; launches {launches}",
          flush=True)
    for fn in counted:
        if fn.__name__ != "leaf_insert":
            require(launches[fn.__name__] > 0,
                    f"{fn.__name__} was not launched in the windowed phase")
    require(stats["segments_evicted"] > 0, "windowed: nothing evicted")

    drop = sk.segments.items_dropped
    suffix = tuple(a[drop:] for a in stream)
    fresh = HiggsSketch(params)
    t1 = time.perf_counter()
    ingest(fresh, suffix, len(suffix[0]))
    torch.cuda.synchronize()
    fresh_s = time.perf_counter() - t1
    require(np.array_equal(sk.leaf_starts, fresh.leaf_starts)
            and np.array_equal(sk.leaf_ends, fresh.leaf_ends),
            "windowed: leaf index differs from the fresh suffix build")
    nonempty_pools_equal(sk, fresh, "windowed vs fresh suffix")
    fresh_res, _ = answer_all(fresh, api, queries, ranges)
    for key, (est, _) in results.items():
        require(np.array_equal(est, fresh_res[key][0]),
                f"windowed: {key} answers differ from the fresh suffix build")
    are = check_answers(suffix, queries, results, ranges)
    print(f"windowed: fresh build on the retained suffix ({len(suffix[0])} "
          f"edges from item {drop}, {fresh_s:.2f} s) has the same leaf "
          f"index, non-empty pools and answers; no estimate below the exact "
          f"count over the retained items; ARE {are}", flush=True)
    del fresh
    out = dict(ingest_s=ingest_s, edges_per_s=N_EDGES / ingest_s,
               query_s=q_s, launches=launches, peak_bytes=peak,
               peak_ingest_bytes=peak_ingest, base_bytes=base_bytes,
               held_bytes=held, cascade_s=cascade_s,
               retention_stats=stats, ranges=ranges,
               pools=[(p.n, p.base) for p in sk.pools],
               overflow_entries=sk.ob.total_entries(),
               space_bytes=sk.space_bytes(), items_dropped=drop,
               fresh_suffix_s=fresh_s, are=are)
    return sk, results, out


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def resume_phase(torch, api, stream, queries, win, win_results, ranges):
    """``run_resumable`` into a directory under ``chiprun_out/`` with the
    windowed policy, a snapshot every 8 batches (2 kept); a
    ``PreemptionGuard`` stops it after batch 17 (a final snapshot), and a
    new sketch and pipeline resume from there and finish.  The result
    must equal the uninterrupted windowed sketch bit for bit."""
    import shutil
    import tempfile

    from repro_torch.runtime.fault import (PreemptionGuard,
                                           run_with_preemption)
    from repro_torch.stream.pipeline import StreamPipeline

    HiggsSketch, HiggsParams, _, _ = api
    params = HiggsParams(retention=f"window:{WINDOW}")
    OUT.mkdir(exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix="resume_", dir=OUT))
    timing = {"save": [], "restore": []}

    def timed(pipe):
        for name in ("snapshot", "restore_snapshot"):
            fn = getattr(pipe, name)

            def wrapper(*a, fn=fn, key=("save" if name == "snapshot"
                                        else "restore"), **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                timing[key].append(time.perf_counter() - t0)
                return out
            setattr(pipe, name, wrapper)
        return pipe

    try:
        guard = PreemptionGuard(install=False)
        batches = [0]

        def progress(cursor):
            batches[0] += 1
            if batches[0] == RESUME_STOP_AFTER:
                guard.request_stop()

        pipe = timed(StreamPipeline(*stream, batch=BATCH))
        t0 = time.perf_counter()
        run_with_preemption(pipe, HiggsSketch(params), str(ckpt),
                            every=RESUME_EVERY, keep=RESUME_KEEP,
                            guard=guard, progress=progress)
        first_s = time.perf_counter() - t0
        require(pipe.cursor < N_EDGES, "resume: the run was not stopped")
        stopped_at, bytes_at_stop = pipe.cursor, dir_bytes(ckpt)
        pipe2 = timed(StreamPipeline(*stream, batch=BATCH))
        sk2 = HiggsSketch(params)
        t1 = time.perf_counter()
        pipe2.run_resumable(sk2, str(ckpt), every=RESUME_EVERY,
                            keep=RESUME_KEEP)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t1
        require(pipe2.cursor == N_EDGES, "resume: the run did not finish")
        final_bytes = dir_bytes(ckpt)
        kept = sorted(p.name for p in ckpt.iterdir())
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    state_equal(win, sk2, "resumed vs uninterrupted windowed sketch")
    parts = snapshot_parts(torch, api, sk2)
    res2, _ = answer_all(sk2, api, queries, ranges)
    for key, (est, _) in win_results.items():
        require(np.array_equal(est, res2[key][0]),
                f"resume: {key} answers differ from the uninterrupted run")
    n_snap = len(timing["save"])
    print(f"resume: stopped after batch {RESUME_STOP_AFTER} at item "
          f"{stopped_at} ({first_s:.2f} s, {bytes_at_stop} bytes on disk), "
          f"resumed and finished in {second_s:.2f} s; {n_snap} snapshots, "
          f"save {sum(timing['save']):.2f} s in all (each "
          f"{[round(x, 3) for x in timing['save']]}), restore "
          f"{sum(timing['restore']):.2f} s; {final_bytes} bytes on disk at "
          f"the end ({kept}); state_dict and answers equal the "
          f"uninterrupted windowed sketch; one snapshot in parts (s): "
          f"{parts}", flush=True)
    del sk2
    return dict(parts=parts, stopped_at=stopped_at, first_s=first_s,
                second_s=second_s,
                snapshots=n_snap, save_s=timing["save"],
                restore_s=timing["restore"], bytes_at_stop=bytes_at_stop,
                final_bytes=final_bytes, kept=kept)


def snapshot_parts(torch, api, sk) -> dict:
    """Where one snapshot's time goes: ``state_dict`` (the pools' one
    device-to-host copy per field, the overflow columns), writing the
    npz and manifest, reading them back, and ``load_state``."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.store import restore_arrays, save_checkpoint

    HiggsSketch, HiggsParams, _, _ = api
    d = Path(tempfile.mkdtemp(prefix="parts_", dir=OUT))
    try:
        t0 = time.perf_counter()
        arrays, meta = sk.state_dict()
        t1 = time.perf_counter()
        save_checkpoint(str(d), 0, arrays, {"summary": "higgs",
                                            "state": meta})
        t2 = time.perf_counter()
        got, meta2 = restore_arrays(str(d), 0)
        t3 = time.perf_counter()
        HiggsSketch(HiggsParams()).load_state(got, meta2["state"])
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        nbytes = dir_bytes(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    n_ob = sum(1 for k in arrays if k.startswith("ob/"))
    pool_bytes = sum(a.nbytes for k, a in arrays.items()
                     if k.startswith("pool"))
    return dict(state_dict=round(t1 - t0, 3), write=round(t2 - t1, 3),
                read=round(t3 - t2, 3), load_state=round(t4 - t3, 3),
                bytes=nbytes, arrays=len(arrays), ob_arrays=n_ob,
                pool_bytes=pool_bytes)


def plan_mass(sk, ts: int, te: int) -> float:
    """The mass the sketch holds for [ts, te]: every matrix weight and
    overflow entry of the nodes its boundary search returns (float64)."""
    plan, filtered = sk.boundary_search(ts, te)
    require(not filtered, "budget: a full-range plan filtered a leaf")
    total = 0.0
    for level, ids in plan.items():
        pool = sk.pools[level - 1]
        slots = pool.slots_of(ids)
        w = pool.device_view().w
        total += float(w[slots.tolist()].double().sum())
        for u in ids:
            rec = sk.ob.get(level, int(u))
            if rec is not None:
                total += float(rec["w"].sum())
    return total


def budget_phase(torch, api, stream, queries, budget):
    """The 1.1M prefix under a byte budget (half the unbounded prefix
    sketch's space): after every insert the space stays within it (or
    only the active region is left), full-range answers are >= exact, and
    the mass the sketch holds is that of the items it still holds."""
    HiggsSketch, HiggsParams, _, _ = api
    sk = HiggsSketch(HiggsParams(retention=f"budget:{budget}"))
    q = tuple(x[:1024] for x in queries)
    steps = []
    t0 = time.perf_counter()
    for lo in range(0, PREFIX, BATCH):
        hi = min(lo + BATCH, PREFIX)
        sk.insert(*(a[lo:hi] for a in stream))
        st = sk.segments
        space = sk.space_bytes()
        require(space <= budget or not st.records,
                f"budget: {space} bytes over the budget {budget} with "
                f"{len(st.records)} segments retained")
        # what the sketch holds: the closed leaves' items, less the
        # evicted segments' (the oldest)
        closed = sk.n_items - sk._buf_len
        held_items = tuple(a[st.items_evicted:closed] for a in stream)
        full = {"full": (int(stream[3][0]), int(stream[3][hi - 1]))}
        res, _ = answer_all(sk, api, q, full)
        check_answers(held_items, q, res, full)
        held = float(held_items[2].sum(dtype=np.float64))
        mass = plan_mass(sk, *full["full"])
        require(abs(mass - held) <= 1e-9 * held,
                f"budget: held mass {mass} against {held}")
        steps.append(dict(sk.retention_stats(), items=hi, mass=mass))
    secs = time.perf_counter() - t0
    stats = sk.retention_stats()
    require(stats["segments_coarse"] > 0, "budget: nothing coarsened")
    print(f"budget: {PREFIX} edges under {budget:.0f} bytes in {secs:.2f} s "
          f"(queries and checks included); final {stats}; nodes per level "
          f"{pools_line(sk)}; space within the budget, full-range answers "
          f">= exact and mass conserved after each of {len(steps)} inserts",
          flush=True)
    return dict(budget=budget, seconds=secs, steps=steps)


def large_leaf_phase(torch, api, tcm, li, stream, queries, counted):
    """d1 = 64, b = 3: a leaf's slots (240 KB) do not fit a block's
    shared memory, so K1 runs its global-memory form.  One real drain is
    held bit for bit against the plain version and timed; then the first
    2^20 edges go through such a sketch (counts 0 before, read after)
    and its answers must be >= exact."""
    HiggsSketch, HiggsParams, _, _ = api
    params = HiggsParams(d1=LARGE_D1, b=LARGE_B)
    sk = HiggsSketch(params)
    captured = {}
    capture_first_drain(sk, captured)
    sk.insert(*(a[:BATCH] for a in stream))
    del sk
    L, d, _, b = captured["shape"]
    r, items = captured["r"], captured["items"]
    n = items[0].shape[1]
    dev = items[0].device

    def fresh():
        return tcm.make_nodes(L, d, b, dev)

    g0 = li.leaf_insert_batched.global_launches
    kn, ks = li.leaf_insert_batched(fresh(), *items, r=r)
    require(li.leaf_insert_batched.global_launches == g0 + 1,
            "large leaf: K1 did not take its global-memory form")
    # the plain version takes seconds here: its one timed call is this one
    box = {"nodes": fresh()}
    plain_ms = one_call_ms(torch, lambda: box.update(
        plain=li.leaf_insert_batched_plain(box["nodes"], *items, r=r)), 1)
    pn, ps = box["plain"]
    for f, a, c in zip(kn._fields, kn, pn):
        require(torch.equal(a, c), f"large leaf: field {f} differs from the "
                f"plain version")
    require(torch.equal(ks, ps), "large leaf: spill mask differs")
    err = float((kn.w - pn.w).abs().max())

    def setup():
        box["nodes"] = fresh()

    def launch(nodes):
        li.leaf_insert_batched(nodes, *items, r=r)

    ms, covered = b2b_ms(torch, launch, lambda i: (fresh(),))
    cold, cov2 = cold_ms(torch, launch, lambda i: (fresh(),))
    one = one_call_ms(torch, lambda: launch(box["nodes"]), 10, setup=setup)
    written = int((kn.fp_s != -1).sum())
    nbytes = L * n * (4 * 4 + 1 + 2 * 4 * r + 4) + written * 20
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"phase leaf_insert_batched (global memory): L={L} n={n} d={d} "
          f"b={b} r={r} bit-exact vs plain; kernel {ms:.4f} ms back to back, "
          f"{cold:.4f} ms cold (covered={covered and cov2}), one call "
          f"{one:.4f} ms, plain {plain_ms:.1f} ms, bound {bound:.4f} ms "
          f"({written} slots written, {L * n} items read, at 3.35 TB/s), "
          f"{int(ks.sum())} items spilled", flush=True)

    reset_counts(counted)
    sk2 = HiggsSketch(params)
    t0 = time.perf_counter()
    ingest(sk2, stream, LARGE_EDGES)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    sub = tuple(a[:LARGE_EDGES] for a in stream)
    q = tuple(x[:1024] for x in queries)
    res, _ = answer_all(sk2, api, q, ranges_of(sub[3]))
    launches = {fn.__name__: fn.launches for fn in counted}
    launches["leaf_insert_batched_global"] = \
        li.leaf_insert_batched.global_launches
    require(launches["leaf_insert_batched_global"] > 0,
            "large leaf: the global-memory form was not launched")
    are = check_answers(sub, q, res)
    print(f"large leaf: {LARGE_EDGES} edges into a d1={d} b={b} sketch in "
          f"{ingest_s:.2f} s, nodes per level {pools_line(sk2)}; launches "
          f"{launches}; no estimate below exact", flush=True)
    return dict(L=L, n=n, d=d, b=b, r=r, ms=ms, cold_ms=cold,
                one_call_ms=one, covered=covered and cov2,
                plain_ms=plain_ms, bound_ms=bound, bound_bytes=nbytes,
                slots_written=written, max_abs_err=err,
                spilled=int(ks.sum()), launches=launches,
                ingest_s=ingest_s, are=are)


def host_top(prof, k: int):
    """The ``k`` host functions with the most own time (cProfile)."""
    import pstats
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: kv[1][2], reverse=True)[:k]
    return [dict(fn=f"{Path(f).name}:{line}:{name}", calls=nc,
                 own_s=round(tt, 4), cum_s=round(ct, 4))
            for (f, line, name), (_, nc, tt, ct, _) in rows]


def profile_phase(torch, api, stream, sk, queries):
    """Where the time goes.  Ingest (the 1.1M prefix, fresh sketches):
    the device's busy share under torch.profiler (kernel and copy time
    over wall time) with its top kernels, then the host functions by own
    time under cProfile in a second run.  Queries: one more round of the
    main path's nine query batches under cProfile (plans now cached)."""
    import cProfile
    from torch.profiler import ProfilerActivity, profile

    HiggsSketch, HiggsParams, EdgeQuery, VertexQuery = api
    fresh = HiggsSketch(HiggsParams(), device=DEVICE)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ingest(fresh, stream, PREFIX)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top_dev = [dict(name=e.key[:60], calls=e.count,
                    ms=round(e.self_device_time_total / 1e3, 3))
               for e in sorted(dev, key=lambda e: -e.self_device_time_total)
               [:6]]
    print(f"profile ingest {PREFIX} edges: wall {wall_ms:.1f} ms under the "
          f"profiler, device busy {busy_ms:.1f} ms = "
          f"{100 * busy_ms / wall_ms:.1f}% (idle "
          f"{100 - 100 * busy_ms / wall_ms:.1f}%); top kernels {top_dev}",
          flush=True)
    fresh = HiggsSketch(HiggsParams(), device=DEVICE)
    cp = cProfile.Profile()
    cp.enable()
    ingest(fresh, stream, PREFIX)
    torch.cuda.synchronize()
    cp.disable()
    host_ingest = host_top(cp, 10)
    print(f"profile ingest host (cProfile, own seconds): {host_ingest}",
          flush=True)
    e_src, e_dst, v_out, v_in = queries
    cp = cProfile.Profile()
    cp.enable()
    for ts, te in ranges_of(stream[3]).values():
        sk.query([EdgeQuery(e_src, e_dst, ts, te)])
        sk.query([VertexQuery(v_out, ts, te, "out")])
        sk.query([VertexQuery(v_in, ts, te, "in")])
    cp.disable()
    host_query = host_top(cp, 8)
    print(f"profile queries host (cProfile, own seconds): {host_query}",
          flush=True)
    return dict(ingest_wall_ms=wall_ms, ingest_device_busy_ms=busy_ms,
                top_kernels=top_dev, host_ingest=host_ingest,
                host_query=host_query)


def write_report(report: dict) -> None:
    OUT.mkdir(exist_ok=True)
    tmp = OUT / f".chip_smoke.{os.getpid()}.json"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1, default=str)
    os.replace(tmp, OUT / "chip_smoke.json")


def run(torch) -> dict:
    from repro_torch import EdgeQuery, HiggsParams, HiggsSketch, VertexQuery
    from repro_torch.core import cmatrix as tcm
    from repro_torch.kernels import _build
    from repro_torch.kernels import leaf_insert as li
    from repro_torch.kernels import probe as pr
    from repro_torch.stream.generator import wiki_talk_like_stream

    api = (HiggsSketch, HiggsParams, EdgeQuery, VertexQuery)
    counted = (li.leaf_insert_batched, li.leaf_insert, pr.edge_probe,
               pr.vertex_probe)
    t0 = time.perf_counter()
    print(card_line(), flush=True)
    chain_lib = start_chain_build()
    build_s = _build.build_all()
    print(f"build: {len(_build.SOURCES)} sources in {build_s:.1f} s "
          f"(nvcc, sm_90a, into {_build.BUILD_DIR}"
          f"{'; already built' if not _build.BUILD_LOG else ''})", flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    calibrate_sleep(torch)
    t1 = time.perf_counter()
    stream = wiki_talk_like_stream(N_EDGES, seed=STREAM_SEED)
    n_users = N_EDGES // 8
    print(f"stream: {N_EDGES} edges, {n_users} user ids, generated in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    queries = make_queries(stream, n_users, np.random.default_rng(12))

    sk, captured, results, launches, ingest_s, q_s, peak = main_path(
        torch, api, stream, queries, counted)
    print(f"main path: ingest {N_EDGES} edges in {ingest_s:.2f} s = "
          f"{N_EDGES / ingest_s:.0f} edges/s; {len(results) * Q} queries in "
          f"{q_s:.2f} s = {len(results) * Q / q_s:.0f} queries/s", flush=True)
    print(f"main path: {sk.n_levels} levels, nodes per level "
          f"{[p.n for p in sk.pools]}, {sk.ob.total_entries()} overflow "
          f"entries, space_bytes {sk.space_bytes():.0f}, "
          f"max_memory_allocated {peak}", flush=True)
    print(f"main path launches: {launches}; aggregation seconds per "
          f"parent level {fmt_secs(captured['cascade_s'])}", flush=True)
    for fn in (li.leaf_insert_batched, pr.edge_probe, pr.vertex_probe):
        require(launches[fn.__name__] > 0,
                f"{fn.__name__} was not launched on the main path")
    are = check_answers(stream, queries, results)
    for key, (v, npos) in are.items():
        print(f"answers {key}: no estimate below exact; ARE "
              f"{v if v is None else f'{v:.6f}'} over {npos} queries with "
              f"exact > 0", flush=True)
    stats = {f"{k}/{n}": s.__dict__ for (k, n), (_, s) in results.items()}

    chain = chain_bench(torch, *chain_lib)
    k12 = k1_k2_phase(torch, tcm, li, captured, chain)
    k34, probe_levels = probe_phase(torch, tcm, pr, sk, queries)
    shared, shared_levels = shared_lines_phase(torch, tcm, pr, sk, stream)
    edge_levels, k3_sweep = edge_levels_phase(torch, tcm, pr, sk, queries,
                                              captured, stream)
    l2 = l2_bench(torch, chain_lib[0])
    wide = wide_bucket_phase(torch, tcm, pr)
    for name, tot in (*k34.items(), ("vertex_probe_shared", shared)):
        print(f"sum over levels {name}: kernel {tot['ms']:.4f} ms back to "
              f"back, {tot['cold_ms']:.4f} ms cold, one call "
              f"{tot['one_call_ms']:.4f} ms, plain {tot['plain_ms']:.3f} ms, "
              f"bound {tot['bound_ms']:.4f} ms", flush=True)
    prof = profile_phase(torch, api, stream, sk, queries)
    main_cascade_s = captured["cascade_s"]
    # the captured drain and edge batches hold the main path's slabs, and
    # a sketch and its planner refer to each other: only the cycle
    # collector frees them
    del sk, captured
    gc.collect()
    torch.cuda.empty_cache()
    prefix_space = prefix_phase(torch, api, stream, queries)
    gc.collect()
    torch.cuda.empty_cache()
    win, win_results, windowed = windowed_phase(torch, api, stream, queries,
                                                counted)
    resume = resume_phase(torch, api, stream, queries, win, win_results,
                          windowed["ranges"])
    del win
    gc.collect()
    torch.cuda.empty_cache()
    budget = budget_phase(torch, api, stream, queries, prefix_space / 2)
    large = large_leaf_phase(torch, api, tcm, li, stream, queries, counted)

    src = "src/repro_torch/kernels/csrc/"
    rows = [
        ("leaf_insert_batched", "leaf_insert.cu",
         "src/repro/kernels/leaf_insert.py:176", k12["leaf_insert_batched"]),
        ("leaf_insert", "leaf_insert.cu",
         "src/repro/kernels/leaf_insert.py:88", k12["leaf_insert"]),
        ("edge_probe", "probe.cu", "src/repro/kernels/probe.py:107",
         edge_levels["all levels"]),
        ("vertex_probe", "probe.cu", "src/repro/kernels/probe.py:139",
         k34["vertex_probe"]),
    ]
    kernels = [dict(name=name, route="cuda", source=src + f,
                    replaces=rep, launches=launches[name],
                    max_abs_err=m["max_abs_err"], ms=m["ms"],
                    plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                    bound_by="bytes", library_ms=None,
                    cold_ms=m["cold_ms"], one_call_ms=m["one_call_ms"],
                    chain_bound_ms=m.get("chain_bound_ms"))
               for name, f, rep, m in rows]
    # K1's global-memory form: its launches are those of the large-leaf
    # sketch run (the main path's leaves fit shared memory)
    kernels.append(dict(
        name="leaf_insert_batched_global", route="cuda",
        source=src + "leaf_insert.cu",
        replaces="src/repro/kernels/leaf_insert.py:176",
        launches=large["launches"]["leaf_insert_batched_global"],
        max_abs_err=large["max_abs_err"], ms=large["ms"],
        plain_ms=large["plain_ms"], bound_ms=large["bound_ms"],
        bound_by="bytes", library_ms=None, cold_ms=large["cold_ms"],
        one_call_ms=large["one_call_ms"], chain_bound_ms=None))
    report = dict(kernels=kernels, k1_k2=k12, chain=chain, probes=k34,
                  probe_levels=probe_levels, shared_lines=shared,
                  shared_lines_levels=shared_levels,
                  edge_levels=edge_levels, edge_levels_sweep=k3_sweep,
                  l2_read=l2, wide_buckets=wide, profile=prof,
                  answers=are, query_stats=stats, ingest_s=ingest_s,
                  main_cascade_s=main_cascade_s,
                  windowed=windowed, resume=resume, budget=budget,
                  large_leaf=large, prefix_space_bytes=prefix_space,
                  query_s=q_s, peak_bytes=peak,
                  total_s=time.perf_counter() - t0)
    write_report(report)
    return {"kernels": kernels}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        print("usage: python3 chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    try:
        summary = run(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(summary))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
