"""Several devices, one rank a device: mesh shapes (``mesh.py``), the
ranks of a group under ``torch.distributed`` (``ranks.py``), and the
model split over them (``sharding.py``, ``collectives.py``, ``ring.py``,
``pipeline.py``, ``moe.py``; the dry run of every mode, ``dryrun.py``).
Counterpart of ``rafiki_tpu/parallel/``."""
