#!/bin/bash
# The several-card abort-at-exit check, on a host with four cards:
#
#     bash scripts/torch_cards_c4b.sh
#
# Two processes, each a `python3 -c` (a follower's `spawn` needs a main
# module it can re-import): chip_smoke's phase 10 and then its own-group
# run over 4 cards with the kernel profile on rank 0, in ONE process (the
# shape that once aborted at exit); then the profiled own-group run alone.
# Each prints the threads it still has at its end
# (/proc/self/task/*/comm), and its exit code is echoed after it.
cd "$(dirname "$0")/.."
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
pre='import torch; torch.backends.cuda.matmul.allow_tf32 = False; torch.backends.cudnn.allow_tf32 = False; import chip_smoke as cs'
post='import os; print("threads at exit:", sorted(open(f"/proc/self/task/{t}/comm").read().strip() for t in os.listdir("/proc/self/task")), flush=True)'
t0=$(date +%s)
python3 -c "$pre; card = cs.header(); cs.cards_phase(card); cs.cards_own_group(card, 4, profile=True); $post" 2>&1 | grep -v "^  " | tail -40
echo "RC c4b (phase 10 then profiled own group): ${PIPESTATUS[0]} in $(( $(date +%s) - t0 )) s"
t1=$(date +%s)
python3 -c "$pre; card = cs.header(); cs.cards_own_group(card, 4, profile=True); $post" 2>&1 | grep -v "^  " | tail -25
echo "RC profiled own group alone: ${PIPESTATUS[0]} in $(( $(date +%s) - t1 )) s"
