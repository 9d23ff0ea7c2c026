"""rafiki_tpu_torch — the PyTorch/CUDA port of rafiki_tpu for NVIDIA Hopper.

The port follows ``rafiki_tpu``'s module layout, so each module's JAX
counterpart sits at the same path there; ``rafiki_tpu`` stays the
reference that the port's tests hold it against. The port imports
nothing of ``rafiki_tpu`` and nothing of JAX.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, or a ``"cpu"`` device grant): see :mod:`.device`.
"""
