"""Percent of kernel B's roofline: the least time of its calls
(rooflines/B.py) over the device time of the kernels its spans launched."""

from port_bench.readings import roofline


def read(run):
    return roofline(run, "B")
