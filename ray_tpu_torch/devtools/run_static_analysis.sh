#!/usr/bin/env bash
# Static-analysis gate for ray_tpu_torch: the port's counterpart of the
# repo root's run_static_analysis.sh. Four stages, all must pass:
#
#   0. self-check — raylint lints its own engine (ray_tpu_torch/devtools/),
#      the port's fixture corpus round-trips its expected.json exactly,
#      and the machine-readable `--rules` listing is cross-checked against
#      this header and the rule table of README.md's section on the port's
#      devtools, so neither can drift.
#   1. raylint — the framework-aware AST linter (R1..R29: the
#      whole-program call-graph rules, the path-sensitive dataflow rules,
#      the cross-process stitched-graph rules, the field-level
#      thread-safety rules R23-R25, and the PyTorch forms of R5, R21 and
#      the SPMD sharding rules R27-R29) over ray_tpu_torch/, the port's
#      tests (tests/test_torch_*.py: the engine lints only this
#      package's test files under tests/, and only they close the
#      chaos-point rule) and chip_smoke.py; any finding fails the gate.
#      tests/ runs under a scoped allow profile (see below). Writes a
#      SARIF 2.1.0 log and the R29 collective-cost plan
#      (comms_manifest.json, the input of `python -m ray_tpu_torch.doctor
#      --comms-baseline`'s __manifest__ gate).
#   2. lockwatch — the port's tests once under RAY_TPU_LOCKWATCH=1; every
#      process's LOCKWATCH[ray_tpu_torch] summary must report zero
#      lock-order cycles. (The JAX package, which the tests import too,
#      runs its own watchdog under the same variable; its summary lines
#      start "LOCKWATCH:" and are not this gate's.) Static R11 findings
#      and these runtime reports share one cycle format.
#   3. gcc -fanalyzer — a syntax-only analyzer pass over the port's
#      _native/*.cc translation units.
#
#   ray_tpu_torch/devtools/run_static_analysis.sh      # all four stages
#   SKIP_LOCKWATCH_TESTS=1 ray_tpu_torch/devtools/run_static_analysis.sh
set -uo pipefail
cd "$(dirname "$0")/../.."
export JAX_PLATFORMS=cpu

fail=0
declare -a STAGE_TIMES=()
OUT_DIR="$(mktemp -d "${TMPDIR:-/tmp}/raytpu_torch_lint.XXXXXX")"

stage_done() {  # stage_done <label> <t0> <status>
  local el=$(( SECONDS - $2 ))
  STAGE_TIMES+=("$1: $3 in ${el}s")
  echo "-- $1: $3 (${el}s)"
}

echo "== [stage 0] raylint self-check =="
t0=$SECONDS
st=OK
# (a) the analyzer must be clean under its own rules
if ! python -m ray_tpu_torch.devtools.lint ray_tpu_torch/devtools; then
  st=FAIL; fail=1
fi
# (b) the fixture corpus must round-trip expected.json exactly
if ! python -m ray_tpu_torch.devtools.lint --self-check; then
  st=FAIL; fail=1
fi
# (c) docs drift: the registry is the source of truth for "R1..RN" above
# and for the rule table in README.md
if ! python - <<'EOF'
import json, re, subprocess, sys
listing = json.loads(subprocess.run(
    [sys.executable, "-m", "ray_tpu_torch.devtools.lint", "--rules"],
    capture_output=True, text=True, check=True).stdout)
ids = [r["id"] for r in listing]
rmax = max(int(i[1:]) for i in ids)
header = open("ray_tpu_torch/devtools/run_static_analysis.sh",
              encoding="utf-8").read()
if f"R1..R{rmax}" not in header:
    print(f"drift: the script's header does not say R1..R{rmax}")
    sys.exit(1)
readme = open("README.md", encoding="utf-8").read()
start = readme.find("### The port's devtools")
section = readme[start:readme.find("\n## ", start)] if start >= 0 else ""
missing = [i for i in ids if not re.search(rf"\| \*\*{i}\*\* \|", section)]
if missing:
    print(f"drift: README.md's devtools rule table is missing {missing}")
    sys.exit(1)
print(f"docs in sync with registry ({len(ids)} rules, R1..R{rmax})")
EOF
then
  st=FAIL; fail=1
fi
stage_done "stage 0 (self-check)" "$t0" "$st"

echo "== [stage 1] raylint (ray_tpu_torch, tests/test_torch_*.py, chip_smoke.py) =="
t0=$SECONDS
st=OK
# tests/ allow profile, as the JAX package's gate has it: test code pokes
# checkpoint directories (R9), simulates rank-divergent schedules on
# purpose (R12), registers throwaway metrics (R22), hammers shared state
# from deliberately racing helper threads (R23-R25), and pins
# autopilot-owned knobs (R26); scoped so the package cannot ride on it.
LINT_JSON="$OUT_DIR/lint.json"
LINT_ERR="$OUT_DIR/lint.err"
LINT_SARIF="${RAYLINT_SARIF_OUT:-$OUT_DIR/lint.sarif.json}"
LINT_MANIFEST="${RAYLINT_MANIFEST_OUT:-$OUT_DIR/comms_manifest.json}"
if python -m ray_tpu_torch.devtools.lint ray_tpu_torch tests chip_smoke.py \
     --allow-in "tests/:R9,R12,R22,R23,R24,R25,R26" --json \
     --sarif "$LINT_SARIF" --comms-manifest "$LINT_MANIFEST" \
     > "$LINT_JSON" 2> "$LINT_ERR"; then
  python - "$LINT_JSON" <<'EOF'
import json, sys
rows = json.load(open(sys.argv[1]))
print(f"raylint: {len(rows)} finding(s) over the port, its tests and "
      "chip_smoke.py")
EOF
else
  st=FAIL; fail=1
  python - "$LINT_JSON" <<'EOF'
import collections, json, sys
rows = json.load(open(sys.argv[1]))
per = collections.Counter(r["rule"] for r in rows)
summary = ", ".join(f"{k}: {v}" for k, v in sorted(per.items()))
print(f"raylint: {len(rows)} finding(s) ({summary})", file=sys.stderr)
for r in rows:
    print(f"{r['path']}:{r['line']}: {r['rule']}({r['tag']}): "
          f"{r['message']}", file=sys.stderr)
EOF
fi
cat "$LINT_ERR" >&2
echo "artifacts: $LINT_SARIF, $LINT_MANIFEST"
CACHE_LINE="$(grep -o 'raylint-cache: .*' "$LINT_ERR" | tail -1)"
# Per-rule wall time for the project rules (plus the shared graph
# build), straight from the engine — the first place to look when the
# stage-1 budget check below trips.
TIMES_LINE="$(grep -o 'raylint-times: .*' "$LINT_ERR" | tail -1)"
stage_done "stage 1 (raylint)" "$t0" "$st"
STAGE_TIMES+=("stage 1 cache: ${CACHE_LINE#raylint-cache: }")
STAGE_TIMES+=("stage 1 rule times: ${TIMES_LINE#raylint-times: }")
# Budget check against the recorded cold-cache baseline of this stage
# (R1..R29 over the port, its tests and chip_smoke.py, the stitch pass,
# the field plan and the sharding model included; 42 s when this gate
# was written, 3 s warm): a >50% overshoot means a rule regressed into
# super-linear work or the cache stopped landing.
STAGE1_BASELINE_S="${RAYLINT_STAGE1_BASELINE_S:-45}"
st1_el=$(( SECONDS - t0 ))
if [ "$st1_el" -gt $(( STAGE1_BASELINE_S * 3 / 2 )) ]; then
  echo "WARNING: stage 1 took ${st1_el}s, >50% over its recorded" \
       "baseline of ${STAGE1_BASELINE_S}s — check rule cost or cache" >&2
  STAGE_TIMES+=("stage 1 budget: OVER (${st1_el}s vs ${STAGE1_BASELINE_S}s baseline)")
fi

echo "== [stage 2] lockwatch (the port's tests under RAY_TPU_LOCKWATCH=1) =="
t0=$SECONDS
st=OK
if [ "${SKIP_LOCKWATCH_TESTS:-0}" = "1" ]; then
  st=SKIPPED
  echo "skipped (SKIP_LOCKWATCH_TESTS=1)"
else
  LW_LOG="$OUT_DIR/lockwatch.log"
  RAY_TPU_LOCKWATCH=1 \
    timeout -k 10 1800 python -m pytest tests/test_torch_*.py -q \
      -m 'not slow' -p no:cacheprovider -p no:xdist -p no:randomly 2>&1 \
      | tee "$LW_LOG" | tail -5
  # Every summary line of the port's watchdog (one per process that
  # imported ray_tpu_torch) must report zero cycles; the suite's own
  # pass/fail is the test run's job.
  if grep -a "^LOCKWATCH\[ray_tpu_torch\]: " "$LW_LOG" \
      | grep -av ", 0 cycles," | grep -aq .; then
    echo "FAIL: lock-order cycles observed:" >&2
    grep -a "^LOCKWATCH\[ray_tpu_torch\]" "$LW_LOG" \
      | grep -av ", 0 cycles," >&2
    st=FAIL; fail=1
  elif ! grep -aq "^LOCKWATCH\[ray_tpu_torch\]: " "$LW_LOG"; then
    echo "FAIL: no LOCKWATCH[ray_tpu_torch] summary seen — the watchdog" \
         "did not install" >&2
    st=FAIL; fail=1
  else
    echo "lockwatch: zero cycles across $(grep -ac \
      '^LOCKWATCH\[ray_tpu_torch\]: ' "$LW_LOG") process summaries"
  fi
fi
stage_done "stage 2 (lockwatch)" "$t0" "$st"

echo "== [stage 3] gcc -fanalyzer over ray_tpu_torch/_native/*.cc =="
t0=$SECONDS
st=OK
for src in ray_tpu_torch/_native/*.cc; do
  echo "-- $src"
  if ! g++ -fanalyzer -fsyntax-only -std=c++17 -I ray_tpu_torch/_native \
        "$src"; then
    st=FAIL; fail=1
  fi
done
stage_done "stage 3 (gcc -fanalyzer)" "$t0" "$st"

echo "== stage timings =="
for line in "${STAGE_TIMES[@]}"; do
  echo "  $line"
done

if [ "$fail" -ne 0 ]; then
  echo "static analysis: FAIL" >&2
  exit 1
fi
echo "static analysis: OK"
