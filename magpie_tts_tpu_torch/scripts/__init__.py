"""H100 counterparts of the JAX package's TPU probe scripts (scripts/ at the
root of the repository), under the same file names:

- ``probe_int4``: the int4 / packed-int8 / bf16 GEMV (kernels 11-13);
- ``opt_int8_attend_probe`` and ``opt_attend_probe``: the int8 and
  orientation attends (kernels 14 and 18);
- ``opt_slope_probe`` and ``opt_launch_probe``: the launch-cost copy kernels
  (15-17), and the port's frame kernels timed by the same slope.

Each runs as ``python -m magpie_tts_tpu_torch.scripts.<name>`` with the JAX
script's arguments and environment variables plus ``--device`` (default
``cuda``; ``cpu`` times the plain versions). ``timing`` holds the harness:
CUDA-graph slope, eager slope, CUDA-event mean. Importing any of these
modules does nothing.
"""
