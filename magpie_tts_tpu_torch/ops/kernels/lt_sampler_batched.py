"""Kernel 7: the split path's LT sampler for B slots.

``sample_frame_codes_batched`` replaces the TPU kernel
magpie_tts_tpu/ops/pallas_kernels/lt_sampler_batched.py
``sample_frame_codes_batched_pallas``: each slot's 8 local-transformer
phases with its own seed and EOS flag, every LT weight read once for all
slots. On CUDA tensors it launches the ``magpie_lt_sample_batched_f32`` /
``_bf16`` entry point of csrc/frame_step_batched.cu (kernel C's LT sequence,
stopping at the codes; the hidden rows' dtype picks one) or raises; on CPU tensors it runs
``sample_frame_codes_batched_reference``: per slot, the plain
``models.local_transformer.sample_frame_codes``.

Any B >= 1, one launch (on the CPU, one plain call) a slot group of at most
64 (``frame_step_batched.slot_groups``): the TPU kernel's ``B % 8`` rule
(``batched_shapes_ok``) is a Mosaic tiling rule, not the model's.
"""

from __future__ import annotations

import threading

import torch

from ...config import MagpieConfig
from ...io.magpie_weights import MagpieWeights
from . import frame_step_batched as fsb
from .lt_sampler import sample_frame_codes_reference

ENTRY = "magpie_lt_sample_batched"
launches = 0  # device launches (one a slot group) since the last reset
dtype_launches = dict.fromkeys(("float32", "bfloat16"), 0)  # the same, by compute dtype
_launches_lock = threading.Lock()  # engines on several cards launch from a thread pool


def declare(lib) -> None:
    fsb.declare(lib, ENTRY)


def sample_frame_codes_batched_reference(hidden: torch.Tensor, weights: MagpieWeights,
                                         config: MagpieConfig, seeds: torch.Tensor,
                                         temperature: float, top_k: int,
                                         forbid_eos: torch.Tensor):
    """Plain PyTorch LT sampling, one slot at a time: (sampled, argmax)
    [B, 8] int32."""
    seeds_l, forbid_l = seeds.tolist(), forbid_eos.tolist()
    codes = [sample_frame_codes_reference(hidden[b], weights, config, seeds_l[b], temperature,
                                          top_k, bool(forbid_l[b]))
             for b in range(hidden.shape[0])]
    return torch.stack([s for s, _ in codes]), torch.stack([a for _, a in codes])


def sample_frame_codes_batched(hidden: torch.Tensor, weights: MagpieWeights,
                               config: MagpieConfig, seeds: torch.Tensor, temperature: float,
                               top_k: int, forbid_eos: torch.Tensor):
    """Sample 8 codes for each of B slots: hidden [B, d_model], seeds [B]
    int32 (each slot's frame seed), forbid_eos [B] bool. Any B >= 1: one
    launch a slot group. No value is read back to the host. Returns (sampled
    [B, 8] int32, argmax [B, 8] int32)."""
    c = config
    dev = hidden.device
    B = hidden.shape[0]
    groups = fsb.slot_groups(B)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sample_frame_codes_batched: unsupported device {dev}")
    per_slot = dict(hidden=hidden, seeds=seeds, forbid_eos=forbid_eos)
    out = dict(sampled=torch.empty(B, c.num_codebooks, dtype=torch.int32, device=dev),
               argmax=torch.empty(B, c.num_codebooks, dtype=torch.int32, device=dev))
    if dev.type == "cuda":
        dtype = fsb.compute_dtype(ENTRY, hidden)
        fsb.check_config(ENTRY, c, top_k)

    def plain(**g):
        return sample_frame_codes_batched_reference(weights=weights, config=c,
                                                    temperature=temperature, top_k=top_k, **g)

    def kernel(g, o, n):
        global launches
        fsb.launch(fsb.entry_name(ENTRY, dtype), n,
                   fsb.sampler_tensors(g["hidden"], g["forbid_eos"], g["seeds"], weights, c),
                   o, c, dev, top_k=min(int(top_k), c.vocab_per_cb),
                   temperature=float(temperature))
        with _launches_lock:
            launches += 1
            fsb.count_dtype(dtype_launches, dtype)

    fsb.run_groups(groups, per_slot, out, plain, kernel)
    return out["sampled"], out["argmax"]
