#!/usr/bin/env bash
# Sanitizer and fault-schedule gates for ray_tpu_torch: the port's
# counterpart of the repo root's run_sanitizers.sh.
#
#   ray_tpu_torch/devtools/run_sanitizers.sh            # ASan
#   ray_tpu_torch/devtools/run_sanitizers.sh thread     # TSan instead
#
# 1. The port's native libraries (_native/{object_store,scheduling,
#    quant}.cc, loaded with ctypes) are rebuilt with -fsanitize=<kind>
#    through RAY_TPU_SANITIZE, which _native/build.py honours (sanitized
#    artifacts get their own suffix), and the port's tests that load them
#    run with the sanitizer runtime LD_PRELOADed. Leak checking is off:
#    CPython itself "leaks" by ASan's definition. The port's state
#    service is Python, so there is no standalone binary to sanitize.
#    The runtime's tests load the object store and the scheduler, the
#    state-service tests spawn the port's processes, and the chaos tests
#    run q8 collectives through the quant kernels. test_torch_distributed
#    and test_torch_collective are not run here: their parity cases run
#    the JAX package too (its daemons, its xla group), which reads the same
#    RAY_TPU_SANITIZE, inherits the preload and aborts in ASan's
#    __cxa_throw interceptor check at its first C++ exception; both run in
#    the gates below.
# 2. The chaos gate: the port's runtime, cluster, data and checkpoint
#    tests under a fixed delay-only fault schedule (RAY_TPU_CHAOS).
# 3. The perf gate: the port's observability tests (doctor, dashboard,
#    trainer and collective ledgers) under delay-only chaos on the
#    instrumented paths.
#
# The port's tests compare with the JAX package in the same process, so
# the schedule perturbs both packages alike; a failure means a path
# depends on lucky timing, not on its retries. Seeds are fixed so every
# run applies the same perturbation.
#
# The static counterpart of this gate is run_static_analysis.sh beside
# this script.
set -euo pipefail
cd "$(dirname "$0")/../.."

KIND="${1:-address}"
export RAY_TPU_SANITIZE="$KIND"
export JAX_PLATFORMS=cpu

case "$KIND" in
  address) RT_LIB="$(g++ -print-file-name=libasan.so)" ;;
  thread)  RT_LIB="$(g++ -print-file-name=libtsan.so)" ;;
  *) echo "usage: $0 [address|thread]" >&2; exit 2 ;;
esac

NATIVE_TESTS=(tests/test_torch_runtime.py tests/test_torch_state_service.py
              tests/test_torch_chaos.py)

echo "== [$KIND] native libraries (sanitized .so under LD_PRELOAD) =="
# TSan cannot follow fork() from a multi-threaded interpreter, and the
# state-service tests spawn processes: under TSan only the in-process
# runtime runs (the others run under ASan and the regular suite).
if [ "$KIND" = "thread" ]; then
  TSAN_OPTIONS="report_bugs=1" LD_PRELOAD="$RT_LIB" \
    python -m pytest tests/test_torch_runtime.py -q -p no:cacheprovider
else
  ASAN_OPTIONS="detect_leaks=0:abort_on_error=1" LD_PRELOAD="$RT_LIB" \
    python -m pytest "${NATIVE_TESTS[@]}" -q -p no:cacheprovider
fi
unset RAY_TPU_SANITIZE

echo "== chaos gate (the port's core tests under a delay-only schedule) =="
RAY_TPU_CHAOS="20260805:rpc.client.send@3%7=delay(0.02);state.heartbeat@2%3=delay(0.05);object.push@2%5=delay(0.01);transport.stream@2%6=delay(0.01);checkpoint.write@2%4=delay(0.01)" \
python -m pytest tests/test_torch_runtime.py tests/test_torch_distributed.py \
    tests/test_torch_state_service.py tests/test_torch_data.py \
    tests/test_torch_checkpoint.py tests/test_torch_chaos.py -q \
    -p no:cacheprovider

echo "== perf gate (the port's observability tests under delay-only chaos) =="
# Histograms, federation, the goodput and comms ledgers and the doctor's
# drift checks must hold when latency actually moves on the paths they
# record (task execute, RPC send, collective op, checkpoint write).
RAY_TPU_CHAOS="20260805:task.execute@2%5=delay(0.01);rpc.client.send@3%7=delay(0.005);collective.op@2%5=delay(0.01);checkpoint.write@2%4=delay(0.01)" \
python -m pytest tests/test_torch_doctor.py tests/test_torch_dashboard.py \
    tests/test_torch_collective.py tests/test_torch_trainer.py -q \
    -p no:cacheprovider

echo "sanitizer pass ($KIND) complete"
