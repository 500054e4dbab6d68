#!/usr/bin/env bash
# Time commits against each other on one card: chip_smoke.py runs from
# each checkout in turn, forward and then backward (for two: parent,
# change, change, parent), so all are measured on the same card,
# interleaved.
#
#   git archive <parent> | tar -x -C build/parent      # build/ is ignored
#   git archive $(git write-tree) | tar -x -C build/change
#   bash tools/chip_compare.sh chiprun_out/cmp parent=build/parent \
#       change=build/change
#
# (on a machine with one NVIDIA GPU; each run takes about 2 minutes)
# Run i (1 forward, 2 backward) of checkout NAME writes its JSON report
# to <out>/NAME<i>.json, its standard output to <out>/NAME<i>.log and its
# errors to <out>/NAME<i>.err.  Exits non-zero if any run failed.
set -u
OUT=$(realpath -m "$1")
shift
mkdir -p "$OUT"
rc=0
run() {
  local name=$1 dir=$2 t0 r
  nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
  t0=$(date +%s)
  (cd "$dir" && python3 chip_smoke.py > "$OUT/$name.log" 2> "$OUT/$name.err")
  r=$?
  echo "$name rc=$r seconds=$(( $(date +%s) - t0 ))"
  cp "$dir/chiprun_out/chip_smoke.json" "$OUT/$name.json"
  tail -n 2 "$OUT/$name.log" | cut -c1-300
  tail -n 3 "$OUT/$name.err"
  [ "$r" -eq 0 ] || rc=1
}
names=() dirs=()
for spec in "$@"; do
  names+=("${spec%%=*}")
  dirs+=("$(realpath "${spec#*=}")")
done
n=${#names[@]}
for ((i = 0; i < n; i++)); do run "${names[i]}1" "${dirs[i]}"; done
for ((i = n - 1; i >= 0; i--)); do run "${names[i]}2" "${dirs[i]}"; done
exit $rc
