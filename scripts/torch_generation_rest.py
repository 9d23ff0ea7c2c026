"""Run ``chip_smoke.py``'s phase 13 (generation, the rest: speculative
decoding with a draft trial, and stream continuity) alone on one CUDA
card: the kernel build, phase 8b (the trained LM it serves, and its
store) and phase 13.

    python3 scripts/torch_generation_rest.py

Prints the card's name and power limit, every line of the two phases,
then the phase's launches. Exits non-zero without CUDA or when a phase's
check fails.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = cs.header()
    cs.lm_phase(card)
    t1 = time.perf_counter()
    counts = cs.generation_rest_phase(card)
    print(f"phase 13 launches {counts}; phase 8b "
          f"{t1 - t0:.1f} s with the build, phase 13 "
          f"{time.perf_counter() - t1:.1f} s, in all "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
