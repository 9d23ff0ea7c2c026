"""Several devices: mesh shapes (``mesh.py``) and the ranks of a data
group under ``torch.distributed``, one process a device (``ranks.py``).
Counterpart of the data-parallel part of ``rafiki_tpu/parallel/``."""
