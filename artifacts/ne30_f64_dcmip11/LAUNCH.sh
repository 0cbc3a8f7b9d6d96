#!/bin/sh
# NE30 72L f64 DCMIP1-1 12-day chunked verification.
# qsize=1: the NCL grades tracer 0 only and tracers evolve independently
# (verified: 12-step NE8 f64 qsize=1 vs qsize=4 tracer-0 max|diff| = 1.1e-15,
# pure XLA-fusion reassociation).  4x cheaper than the reference's qsize=4.
# Relaunch with THIS script each session; restart resume is bit-exact.
cd /root/repo
PIDFILE=artifacts/ne30_f64_dcmip11/PID
# Guard: refuse to start a second instance (two runs would race on the
# fixed RESTART.tmp.npz temp name and interleave run.log).
if [ -f "$PIDFILE" ] && kill -0 "$(cat "$PIDFILE")" 2>/dev/null; then
  echo "already running (pid $(cat "$PIDFILE")); not relaunching" >&2
  exit 0
fi
echo $$ > "$PIDFILE"
exec nice -n 19 python scripts/verify_long.py --ne 30 --days 12 --qsize 1 \
  --chunk-steps 48 --workdir artifacts/ne30_f64_dcmip11
