"""Kernel 7: the split path's LT sampler for B slots.

``sample_frame_codes_batched`` replaces the TPU kernel
magpie_tts_tpu/ops/pallas_kernels/lt_sampler_batched.py
``sample_frame_codes_batched_pallas``: each slot's 8 local-transformer
phases with its own seed and EOS flag, every LT weight read once for all
slots. On CUDA tensors it launches the ``magpie_lt_sample_batched_f32`` entry
point of csrc/frame_step_batched.cu (kernel C's LT sequence, stopping at the
codes) or raises; on CPU tensors it runs
``sample_frame_codes_batched_reference``: per slot, the plain
``models.local_transformer.sample_frame_codes``.

Any 1 <= B <= 64: the TPU kernel's ``B % 8`` rule (``batched_shapes_ok``)
is a Mosaic tiling rule, not the model's.
"""

from __future__ import annotations

import threading

import torch

from ...config import MagpieConfig
from ...io.magpie_weights import MagpieWeights
from . import frame_step_batched as fsb
from .lt_sampler import sample_frame_codes_reference

ENTRY = "magpie_lt_sample_batched_f32"
launches = 0  # kernel launches (one per frame) since the last reset
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
    int32 (each slot's frame seed), forbid_eos [B] bool. No value is read
    back to the host. Returns (sampled [B, 8] int32, argmax [B, 8] int32)."""
    global launches
    if hidden.device.type == "cpu":
        return sample_frame_codes_batched_reference(hidden, weights, config, seeds,
                                                    temperature, top_k, forbid_eos)
    if hidden.device.type != "cuda":
        raise ValueError(f"sample_frame_codes_batched: unsupported device {hidden.device}")
    c = config
    B = hidden.shape[0]
    fsb.check_batch(ENTRY, B)
    fsb.check_config(ENTRY, c, top_k)
    dev = hidden.device
    sampled = torch.empty(B, c.num_codebooks, dtype=torch.int32, device=dev)
    argmax = torch.empty(B, c.num_codebooks, dtype=torch.int32, device=dev)
    fsb.launch(ENTRY, B, fsb.sampler_tensors(hidden, forbid_eos, seeds, weights, c),
               dict(sampled=sampled, argmax=argmax), c, dev,
               top_k=min(int(top_k), c.vocab_per_cb), temperature=float(temperature))
    with _launches_lock:
        launches += 1
    return sampled, argmax
