#!/usr/bin/env python3
"""Summarise a chip call of ``tools/chip_compare.sh``.

    python3 tools/compare_report.py chiprun_out/cmp [CHANGE [PARENT]]

reads ``PARENT1/2.json`` and ``CHANGE1/2.json`` (``chip_smoke.py``
reports; the names default to ``parent`` and ``change``) from the
directory and prints, each as the mean of its two runs (the change's
first, the parent's in brackets, then parent / change): the per-level
edge- and vertex-probe rows both versions have, the sums over levels,
the kernels' JSON rows, the all-level edge-probe launches and the
planner edge batches (beside the parent's where it has them), the
change's all-level launch over the first k entries and fewer queries,
its read rates, its wide-bucket vertex probes, and the end-to-end
figures.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np


def load(d: Path, name: str):
    return [json.loads((d / f"{name}{i}.json").read_text()) for i in (1, 2)]


def mean(xs):
    xs = [x for x in xs if x is not None]
    return float(np.mean(xs)) if xs else None


def fmt(x):
    return "-" if x is None else f"{x:.4f}"


def pair(ch, pa, get):
    c = mean([get(r) for r in ch])
    p = mean([get(r) for r in pa]) if pa else None
    ratio = f" {p / c:.2f}x" if c and p else ""
    return f"{fmt(c)} [{fmt(p)}]{ratio}"


def level_rows(rep, kernel):
    return {(r["level"], r.get("direction"), r["match_time"]): r
            for r in rep["probe_levels"] if r["kernel"] == kernel}


def main() -> int:
    d = Path(sys.argv[1])
    names = sys.argv[2:4] + ["change", "parent"][len(sys.argv[2:4]):]
    ch, pa = load(d, names[0]), load(d, names[1])
    print(f"{names[0]} [{names[1]}]")
    print("per level: ms back to back | cold | one call, change [parent]")
    for kernel in ("edge_probe", "vertex_probe"):
        for key in sorted(level_rows(ch[0], kernel),
                          key=lambda k: (k[2], k[1] or "", k[0])):
            row = level_rows(ch[0], kernel)[key]
            cols = [pair([level_rows(r, kernel)[key] for r in ch],
                         [level_rows(r, kernel)[key] for r in pa],
                         lambda r, f=f: r[f])
                    for f in ("ms", "cold_ms", "one_call_ms")]
            print(f"  {kernel} L{key[0]} {key[1] or ''} d={row['d']} "
                  f"m={row['m']} time={key[2]}: " + " | ".join(cols)
                  + f" | bound {fmt(row['bound_ms'])}")
    print("sums over levels (ms back to back | cold | one call | plain)")
    for name in ch[0]["probes"]:
        cols = [pair([r["probes"][name] for r in ch],
                     [r["probes"][name] for r in pa], lambda r, f=f: r[f])
                for f in ("ms", "cold_ms", "one_call_ms", "plain_ms")]
        print(f"  {name}: " + " | ".join(cols))
    print("kernels rows (change): ms | cold | one call | plain | bound | "
          "launches")
    for k in ch[0]["kernels"]:
        vals = [mean([next(x for x in r["kernels"] if x["name"] == k["name"])
                      [f] for r in ch])
                for f in ("ms", "cold_ms", "one_call_ms", "plain_ms",
                          "bound_ms")]
        prow = next((x for x in pa[0]["kernels"]
                     if x["name"] == k["name"]), {"launches": "-"})
        print(f"  {k['name']}: " + " | ".join(fmt(v) for v in vals)
              + f" | {k['launches']} [parent {prow['launches']}]")
    print("all-level edge probe: ms | cold | one call | plain | bound | "
          "edge_batch ms | sector MB of fp_s, of all loads; change "
          "[parent]")
    for tag in ch[0]["edge_levels"]:
        rows = [r["edge_levels"][tag] for r in ch]
        prows = [r["edge_levels"][tag] for r in pa
                 if tag in r.get("edge_levels", {})]
        cols = [pair(rows, prows, lambda x, f=f: x.get(f))
                for f in ("ms", "cold_ms", "one_call_ms", "plain_ms",
                          "bound_ms", "edge_batch_ms")]
        for f in ("sector_bytes", "load_sector_bytes"):
            mb = mean([x.get(f) for x in rows])
            cols.append(fmt(None if mb is None else mb / 1e6))
        print(f"  {tag} ({rows[0]['entries']} entries): " + " | ".join(cols))
    if "edge_levels_sweep" in ch[0]:
        print("all-level edge probe over the first k entries and fewer "
              "queries (change): ms back to back | cold")
        for i, row in enumerate(ch[0]["edge_levels_sweep"]):
            vals = [mean([r["edge_levels_sweep"][i][f] for r in ch])
                    for f in ("ms", "cold_ms")]
            print(f"  {row['tag']} (q={row['q']}): "
                  + " | ".join(fmt(v) for v in vals))
    if "l2_read" in ch[0]:
        print("read rates (change): TB/s")
        for tag in ch[0]["l2_read"]:
            print(f"  {tag}: "
                  + fmt(mean([r["l2_read"][tag]["tb_s"] for r in ch])))
    print("wide buckets, vertex probe b=1024 (change): ms back to back")
    for tag in ch[0]["wide_buckets"]:
        print(f"  {tag}: "
              + fmt(mean([r["wide_buckets"][tag]["ms"] for r in ch])))
    print("end to end, each run: change [parent]")
    for f in ("ingest_s", "query_s", "total_s"):
        print(f"  {f}: {[round(r[f], 2) for r in ch]} "
              f"[{[round(r[f], 2) for r in pa]}]")
    for phase in ("windowed", "resume", "budget", "large_leaf"):
        if phase in ch[0]:
            print(f"  {phase} (change): "
                  + json.dumps([{k: v for k, v in r[phase].items()
                                 if not isinstance(v, (dict, list))}
                                for r in ch], default=str))
    prof = [r["profile"] for r in ch + pa]
    print("  ingest device idle %: "
          + str([round(100 - 100 * p["ingest_device_busy_ms"]
                       / p["ingest_wall_ms"], 1) for p in prof])
          + " (change1, change2, parent1, parent2)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
