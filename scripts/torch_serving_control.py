"""Run ``chip_smoke.py``'s phase 12 (serving control) alone on one CUDA
card: the kernel build, phase 8a (the two BERT-base trials it serves,
and their store) and phase 12.

    python3 scripts/torch_serving_control.py

Prints the card's name and power limit, every line of the two phases,
then K1's fused shape entry and the phase's launches. Exits non-zero
without CUDA or when a phase's check fails.
"""

import json
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
    cs.bert_phase(card)
    t1 = time.perf_counter()
    shape, counts = cs.serving_control_phase(card)
    print("fused K1 shape:", json.dumps(shape))
    print(f"phase 12 launches {counts}; phase 12 "
          f"{time.perf_counter() - t1:.1f} s, in all "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
