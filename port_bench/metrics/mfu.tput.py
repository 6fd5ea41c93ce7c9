"""Percent of the card's peak (bf16 989, float32 at the TF32 rate 495
TFLOP/s) that the flops of the window's completed work (prepare, frames,
codec of the frames delivered; work.py) reach over the window."""

from port_bench.readings import mfu


def read(run):
    return mfu(run)
