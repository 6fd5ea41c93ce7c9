"""Data-parallel device list (magpie_tts_tpu/parallel/mesh.py).

The reference is strictly single-device, batch-1 (SURVEY §2.5); several
devices are new scope, and their one scaling axis is **data parallelism**:
each device runs the whole lockstep program on its slice of the batch, with
its own copy of the weights. No collectives are needed, and each slice's
loop ends on its own streams' EOS.

Tensor parallelism is RETIRED (round 4 of the JAX package), not merely
unimplemented. It was built there (Megatron column / row shardings over a
``model`` axis), tested, and then measured on the TPU: the fused frame
kernel is one hand-pipelined program that a partitioner cannot split, so a
tp > 1 mesh had to run the unfused step, which lost to one chip running the
kernel by more than any 2-way split could win back (docs/DESIGN.md
"Parallelism"). The same holds for the port's frame kernels, which are one
launch sequence over whole weight matrices, and the model (357M, ~0.7 GB in
bf16 plus caches) fits one card with a wide margin. ``make_mesh`` therefore
raises on ``n_model > 1``.

Where the JAX package builds a ``jax.sharding.Mesh``, the port's mesh is an
ordered list of ``torch.device``: entry i serves batch slice i. A device may
appear more than once (``["cuda:0"] * 2``, ``["cpu"] * 4``): its entries
then share one copy of the weights and queue their launches on that card in
turn. ``make_mesh`` never falls back to the CPU; a caller asks for it.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..config import MagpieConfig
from ..io.magpie_weights import MagpieWeights


def _key(d) -> tuple:
    """(type, index) of a device; ``cuda`` alone is the current CUDA device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return "cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0
    return d.type, d.index


def same_device(a, b) -> bool:
    """Whether ``a`` and ``b`` name one device."""
    return _key(a) == _key(b)


def _device(d) -> torch.device:
    """``d`` checked and with its CUDA index filled in, so that entries on one
    card compare equal."""
    from ..runtime.engine import resolve_device

    device = resolve_device(d)
    if device.type != "cuda":
        return device
    device = torch.device(*_key(device))
    if device.index >= torch.cuda.device_count():
        raise ValueError(f"{device}: only {torch.cuda.device_count()} CUDA device(s)")
    return device


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The first ``n_data`` of ``devices`` (default: every CUDA device), in
    order, as ``torch.device``s."""
    if n_model != 1:
        raise ValueError(
            "tensor parallelism is retired for Magpie-357M: on the TPU its unfused step "
            "lost to one chip running the fused kernels, and the model fits a single "
            "device with margin (docs/DESIGN.md 'Parallelism'). Scale with n_data (data "
            "parallelism).")
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= (e.g. ['cpu'] * 4) "
                               "to build a mesh elsewhere")
    devices = [_device(d) for d in devices]
    if n_data is None:
        n_data = len(devices)
    if not 1 <= n_data <= len(devices):
        raise ValueError(f"mesh {n_data}x1 needs {n_data} devices, have {len(devices)}")
    return devices[:n_data]


def replicated(mesh: Sequence[torch.device]) -> Callable[[object], list]:
    """Every mesh entry holds the whole value (the JAX ``P()``): a function
    returning one copy of a value (anything with ``.to(device=...)``) per
    entry, entries on one device sharing a copy."""
    devices = [_device(d) for d in mesh]

    def place(value) -> list:
        copies = {}
        for d in devices:
            if d not in copies:
                copies[d] = value.to(device=d)
        return [copies[d] for d in devices]

    return place


def batch_sharding(mesh: Sequence[torch.device], batch: int) -> List[slice]:
    """The leading (batch) axis cut into equal, contiguous slices, slice i
    for mesh entry i (the JAX ``P("data")``); a batch that does not divide
    over the entries raises, as ``shard_map`` does."""
    n = len(mesh)
    if batch % n:
        raise ValueError(f"batch {batch} does not divide over {n} mesh entries")
    per = batch // n
    return [slice(i * per, (i + 1) * per) for i in range(n)]


def shard_weights(weights: MagpieWeights, mesh: Sequence[torch.device],
                  config: Optional[MagpieConfig] = None) -> List[MagpieWeights]:
    """The weights replicated over the (data-parallel) mesh: one copy per
    entry, shared by entries on the same device. Every device runs whole
    utterances, so each holds the full weights. ``config`` is accepted for
    signature stability."""
    del config
    return replicated(mesh)(weights)
