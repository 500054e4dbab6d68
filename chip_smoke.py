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
3. ingests a 1.1M-edge prefix twice, once through the kernels and once
   through the plain versions (``kernels=False``), and requires equal
   pools, overflow blocks and answers.

To compare two commits, run this same script from a checkout of each:
it times whichever kernels the checkout it sits in holds.

The counts of kernel launches are set to 0 just before the main path and
read just after it.  The line before the last is the card's name and
power limit, the one before it a JSON summary of the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result line, without a GPU, outside a checkout, or if any phase fails.
"""
from __future__ import annotations

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


def ingest(sk, stream, n):
    for lo in range(0, n, BATCH):
        sk.insert(*(a[lo:min(lo + BATCH, n)] for a in stream))
    sk.flush()


def main_path(torch, api, stream, queries, counted):
    """The measured run: counts 0 -> ingest -> queries -> counts read."""
    HiggsSketch, HiggsParams, EdgeQuery, VertexQuery = api
    sk = HiggsSketch(HiggsParams())                 # default device: CUDA
    captured = {}
    insert = sk._pipeline._insert

    def capture_first_drain(nodes, *items, r):
        if not captured:                          # inputs of one real drain
            captured["items"] = [x.clone() for x in items]
            captured["shape"] = tuple(nodes.fp_s.shape)
            captured["r"] = r
        return insert(nodes, *items, r=r)

    sk._pipeline._insert = capture_first_drain
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counted)
    t0 = time.perf_counter()
    ingest(sk, stream, N_EDGES)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    e_src, e_dst, v_out, v_in = queries
    results, q_s = {}, 0.0
    for name, (ts, te) in ranges_of(stream[3]).items():
        for kind, q in (("edge", EdgeQuery(e_src, e_dst, ts, te)),
                        ("out", VertexQuery(v_out, ts, te, "out")),
                        ("in", VertexQuery(v_in, ts, te, "in"))):
            t1 = time.perf_counter()
            res = sk.query([q])
            q_s += time.perf_counter() - t1
            results[(kind, name)] = (np.asarray(res.values[0]), res.stats)
    launches = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated()
    return sk, captured, results, launches, ingest_s, q_s, peak


def check_answers(stream, queries, results):
    src, dst, w, t = stream
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
        ts, te = ranges_of(t)[name]
        ex = exact[kind](qkeys[kind], ts, te)
        require(est.shape == (Q,) and np.isfinite(est).all(),
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

    t = sk.leaf_ends
    ts_mid, te_mid = int(t[len(t) // 3]), int(t[2 * len(t) // 3])
    tot = {k: new_sums() for k in ("edge_probe", "vertex_probe",
                                   "edge_probe_time", "vertex_probe_time")}
    levels = []
    for level in range(1, sk.n_levels + 1):
        pool = sk.pools[level - 1]
        ids = np.unique(np.linspace(0, pool.n - 1, min(pool.n, 6))
                        .astype(np.int64)) + pool.base
        idx, mask = pool.gather_ids(ids)
        slabs = pool.device_view()
        m, d, b, r = len(ids), p.d(level), p.b, p.r
        fs, rows = coords(e_src, "s", level)
        fd, cols = coords(e_dst, "d", level)
        # entries above level 1 carry t = 0: a filter from 0 keeps them
        lo = ts_mid if level == 1 else 0
        for match_time, (ts, te) in ((False, (0, 0xFFFFFFFF)),
                                     (True, (lo, te_mid))):
            f4 = 16 if match_time else 12
            sfx = "_time" if match_time else ""
            args = (slabs, idx, mask, fs, fd, rows, cols, ts, te)
            got = pr.edge_probe(*args, match_time=match_time)
            want = pr.edge_probe_plain(*args, match_time=match_time)
            require(torch.equal(got, want), f"edge_probe L{level} "
                    f"match_time={match_time}: differs from plain")
            bucket = ((idx.to(torch.int64)[None, :, None, None] * d
                       + rows.to(torch.int64)[:, None, :, None]) * d
                      + cols.to(torch.int64)[:, None, None, :])
            nbytes = (int(torch.unique(bucket).numel()) * b * f4
                      + Q * (8 + 8 * r) + m * 5 + Q * 4)
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
        ids = np.unique(np.linspace(0, pool.n - 1, min(pool.n, 6))
                        .astype(np.int64)) + pool.base
        idx, mask = pool.gather_ids(ids)
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
          f"({a.n_levels} levels, {a.ob.total_entries()} overflow entries)",
          flush=True)


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
    print(f"main path launches: {launches}", flush=True)
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
    for name, tot in (*k34.items(), ("vertex_probe_shared", shared)):
        print(f"sum over levels {name}: kernel {tot['ms']:.4f} ms back to "
              f"back, {tot['cold_ms']:.4f} ms cold, one call "
              f"{tot['one_call_ms']:.4f} ms, plain {tot['plain_ms']:.3f} ms, "
              f"bound {tot['bound_ms']:.4f} ms", flush=True)
    prof = profile_phase(torch, api, stream, sk, queries)
    del sk
    torch.cuda.empty_cache()
    prefix_phase(torch, api, stream, queries)

    src = "src/repro_torch/kernels/csrc/"
    rows = [
        ("leaf_insert_batched", "leaf_insert.cu",
         "src/repro/kernels/leaf_insert.py:176", k12["leaf_insert_batched"]),
        ("leaf_insert", "leaf_insert.cu",
         "src/repro/kernels/leaf_insert.py:88", k12["leaf_insert"]),
        ("edge_probe", "probe.cu", "src/repro/kernels/probe.py:107",
         k34["edge_probe"]),
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
    report = dict(kernels=kernels, k1_k2=k12, chain=chain, probes=k34,
                  probe_levels=probe_levels, shared_lines=shared,
                  shared_lines_levels=shared_levels, profile=prof,
                  answers=are, query_stats=stats, ingest_s=ingest_s,
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
