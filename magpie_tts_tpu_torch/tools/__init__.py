"""The port's real-checkpoint tooling, counterparts of the JAX package's
tools/ scripts under the same names:

- ``dump_golden``: per-layer golden tensors of a GGUF checkpoint, in the
  reference's ``.bin`` layout (``io.golden``);
- ``verify_golden``: two dump trees diffed tensor by tensor against the
  reference's per-component tolerances;
- ``acceptance``: the day-one checklist (load, tokens, greedy codes, Q8_0
  serving, per-layer goldens, audio) with one PASS / FAIL verdict.

Each runs as ``python -m magpie_tts_tpu_torch.tools.<name>`` with the JAX
tool's arguments plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch paths). Importing any of these modules does nothing.
"""
