#!/bin/bash
# Phase 15 of chip_smoke.py (model-parallel training) on every card up
# to 4, as one `python3 -c` process (the ranks are `spawn`ed and
# re-import the main module, so never a script on standard input):
#
#     bash scripts/torch_model_parallel_exit.sh
#
# It prints the threads the process still has at its end
# (/proc/self/task/*/comm), and its exit code is echoed after it.
cd "$(dirname "$0")/.."
python3 -c 'import os, chip_smoke as cs; cs.model_parallel_only(); print("threads at exit:", sorted(open(f"/proc/self/task/{t}/comm").read().strip() for t in os.listdir("/proc/self/task")), flush=True)'
echo "RC phase 15: $?"
