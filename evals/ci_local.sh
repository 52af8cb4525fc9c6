#!/bin/bash
# Local executor for the CI the environment cannot run on a hosted runner
# (.github/workflows/ci.yml — this image has no GitHub runner and no
# egress).  Runs the same steps and both test tiers on the CPU (the
# multi-device path runs in tests/test_multichip.py on 8 virtual
# devices); appends a dated evidence record to evals/CI_RUNS.log.
# The reference's CI only compile-checked (.travis.yml:1-8); this enforces
# the full suite.
set -u
cd "$(dirname "$0")/.."
LOG=evals/CI_RUNS.log
START=$(date -u +"%Y-%m-%dT%H:%M:%SZ")
SHA=$(git rev-parse --short HEAD 2>/dev/null || echo "?")

step() { echo "== $1"; }
fail=0

step "native library builds"
python -c "from tidehunter_tpu.native import get_lib; assert get_lib() is not None" || fail=1

step "fast tier"
JAX_PLATFORMS=cpu python -m pytest tests/ -q -rs -p no:cacheprovider; [ $? -eq 0 ] || fail=1

step "slow tier (TH_RUN_SLOW=1)"
JAX_PLATFORMS=cpu TH_RUN_SLOW=1 python -m pytest tests/ -q -p no:cacheprovider; [ $? -eq 0 ] || fail=1

STATUS=$([ $fail -eq 0 ] && echo PASS || echo FAIL)
echo "$START sha=$SHA $STATUS" >> "$LOG"
echo "== CI $STATUS (recorded in $LOG)"
exit $fail
