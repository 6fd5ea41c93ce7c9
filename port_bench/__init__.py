"""The benchmark of ``magpie_tts_tpu_torch`` on one NVIDIA H100.

``python -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line. Everything
that belongs to one configuration, cell, driver, metric or kernel lives in a
file of its own (``configs/``, ``workloads/``, ``drivers/``, ``metrics/``,
``rooflines/``), found by the name ``BENCHMARK.json`` gives it.
"""
