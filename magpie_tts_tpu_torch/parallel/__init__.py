"""Batched serving (magpie_tts_tpu/parallel/): lockstep batches
(``serving.py``), data-parallel over a device list (``mesh.py``), and
continuous batching over a ring cache, one engine per device behind a shared
queue (``continuous.py``)."""
