"""The port's real-checkpoint tooling, counterparts of the JAX package's
tools/ scripts under the same names:

- ``dump_golden``: per-layer golden tensors of a GGUF checkpoint, in the
  reference's ``.bin`` layout (``io.golden``);
- ``verify_golden``: two dump trees diffed tensor by tensor against the
  reference's per-component tolerances;
- ``acceptance``: the day-one checklist (load, tokens, greedy codes, Q8_0
  serving, per-layer goldens, audio) with one PASS / FAIL verdict;
- ``convert_nemo_to_gguf`` and ``convert_codec_to_gguf``: a NeMo ``.nemo``
  checkpoint (model or nano-codec) to GGUF, byte for byte as the JAX tools
  write it (``io.gguf.GGUFWriter``);
- ``inspect_gguf``: a GGUF file's metadata and tensor table;
- ``dump_reference_nemo``: golden tensors of the real NeMo model by forward
  hooks (NeMo itself is imported only when a checkpoint is loaded).

Each runs as ``python -m magpie_tts_tpu_torch.tools.<name>`` with the JAX
tool's arguments; the first three also take ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch paths), the others touch no device.
Importing any of these modules does nothing.
"""
