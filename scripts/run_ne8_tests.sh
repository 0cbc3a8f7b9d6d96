#!/usr/bin/env bash
# NE8 verification runs: DCMIP 1-1 (12 days) and DCMIP 1-2 (1 day),
# error norms compared against the published reference values.
# Analog of reference test/run_ne8_tests.sh (README:38-44: "L1, L2 and
# Linf errors, overshoot and undershoots should agree to 2-3 digits...
# check tracer mass conserved via 'Q, Q diss'").
#
# Usage: scripts/run_ne8_tests.sh [cpu|cuda]   (default cpu, f64)
set -euo pipefail
cd "$(dirname "$0")/.."
PLATFORM="${1:-cpu}"

echo "=== DCMIP 1-2 (1 day, NE8, 72L) ==="
python scripts/verify.py --test dcmip1-2 --ne 8 --platform "$PLATFORM" \
    --dtype f64

echo "=== DCMIP 1-1 (12 days, NE8, 72L) ==="
python scripts/verify.py --test dcmip1-1 --ne 8 --platform "$PLATFORM" \
    --dtype f64
