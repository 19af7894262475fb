#!/usr/bin/env bash
# Runs the PyTorch port's five demos and eleven smokes to completion:
# the port's counterpart of hack/verify-examples.sh.  Each script
# asserts its own invariants and prints its success line; the first
# one that fails or does not print it stops the run with a non-zero
# exit.  All of them run on the CPU (the offload smoke with --device
# cpu): the GPU machine lacks pyzmq, msgpack, tokenizers, xxhash and
# prometheus_client, which the sockets and the reference's clients need.
set -euo pipefail
cd "$(dirname "$0")/.."

run() {  # script, success pattern, then the script's arguments
  local script=$1 pattern=$2
  shift 2
  echo "=== ${script} $*"
  python "${script}" "$@" 2>&1 | grep -E "${pattern}" \
    || { echo "FAIL: ${script}"; exit 1; }
}

for demo in offline_demo index_service_demo online_demo valkey_demo vllm_demo; do
  run "examples/${demo}_torch.py" "completed successfully"
done
run hack/verify_observability_torch.py "completed successfully"
run hack/events_smoke_torch.py "^events smoke ok"
for smoke in cluster slo replay whatif profile cachestats tiering transfer; do
  run "hack/${smoke}_smoke_torch.py" "completed successfully"
done
run hack/offload_smoke_torch.py "completed successfully" --device cpu
echo "all port examples and smokes verified"
