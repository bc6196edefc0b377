#!/bin/bash
# Where the wall time of chip_smoke.py goes, run after run.
#
#     bash scripts/torch_port_timed_smoke.sh [DIR] [RUNS]
#
# Runs DIR/chip_smoke.py (DIR: a checkout or an unpacked `git archive`;
# default the repo root) RUNS times (default 2), one after another. Each
# output line is stamped with the wall clock (%T.%N) into
# chiprun_out/timed_<i>.log of the repo, beside a copy of the run's
# chiprun_out/chip_smoke.json; START and END lines, the exit code, the
# start-up, build and phase-wall lines are printed. A gap shows as a
# start-up leg, a jump between two lines, or between the last line and
# END. Stops at the first run that fails, with its exit code. Needs one
# CUDA card.
here="$(cd "$(dirname "$0")/.." && pwd)"
dir="$(cd "${1:-$here}" && pwd)" || exit 9
runs="${2:-2}"
out="$here/chiprun_out"
mkdir -p "$out"
cd "$dir" || exit 9
for i in $(seq 1 "$runs"); do
  echo "$(date +%T.%N) START run $i"
  python3 chip_smoke.py 2>&1 | while IFS= read -r l; do
    echo "$(date +%T.%N) $l"
  done > "$out/timed_$i.log"
  rc=${PIPESTATUS[0]}
  echo "$(date +%T.%N) END run $i rc=$rc"
  cp chiprun_out/chip_smoke.json "$out/chip_smoke_$i.json" 2>/dev/null
  grep -E "card:|start-up|build:|phase wall|obs wall|wall:|windows \(|window optimizers \([cd]\)" \
    "$out/timed_$i.log" | cut -c1-600
  tail -1 "$out/timed_$i.log" | cut -c1-200
  [ "$rc" -eq 0 ] || exit "$rc"
done
