#!/bin/bash
# Several-card exit check, on a host with four cards:
#
#     bash scripts/torch_cards_exit.sh
#
# Three processes, one after another, each a `python3 -c` (so a
# follower's `spawn` never has a main module to re-import): chip_smoke's
# phase 10 unprofiled; its own-group run over 4 cards with the kernel
# profile on rank 0; the GAN's f32 group step over every card against
# one card's. Each prints the threads it still has at its end
# (/proc/self/task/*/comm), and its exit code is echoed after it.
cd "$(dirname "$0")/.."
pre='import torch; torch.backends.cuda.matmul.allow_tf32 = False; torch.backends.cudnn.allow_tf32 = False; import chip_smoke as cs'
post='import os; print("threads at exit:", sorted(open(f"/proc/self/task/{t}/comm").read().strip() for t in os.listdir("/proc/self/task")), flush=True)'
python3 -c "$pre; cs.cards_phase(cs.header()); $post"
echo "RC unprofiled phase 10: $?"
python3 -c "$pre; card = cs.header(); cs.cards_own_group(card, 4, profile=True); $post"
echo "RC profiled own group: $?"
python3 -c "$pre; cs.gan_cards_step(torch.cuda.get_device_name(0), cs.gan_datasets()[2]); $post"
echo "RC gan group step: $?"
