"""Kernel 4: the split path's LT sampler for one stream.

``sample_frame_codes`` replaces the TPU kernel
magpie_tts_tpu/ops/pallas_kernels/lt_sampler.py ``sample_frame_codes_pallas``:
the 8 local-transformer phases of a frame, each sampling one codebook's code
from the decoder's hidden state. On CUDA tensors it launches the
``magpie_lt_sample_f32`` / ``_bf16`` entry point of csrc/frame_step.cu (the
hidden row's dtype picks one) or raises: one persistent, cooperative launch
a frame, kernel A's LT phases up to the last draw
(csrc/frame_persistent.cuh ``lt_persistent_kernel``, its phase table
``frame_step.plan_lt``), so the split path's codes are the fused path's. On
CPU tensors it runs ``sample_frame_codes_reference``, the plain
``models.local_transformer.sample_frame_codes``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...config import MagpieConfig
from ...io.magpie_weights import MagpieWeights
from . import frame_step as fs

ENTRY = "magpie_lt_sample"
launches = 0  # kernel launches (one per frame) since the last reset
dtype_launches = dict.fromkeys(("float32", "bfloat16"), 0)  # the same, by compute dtype


def declare(lib) -> None:
    fs.declare(lib, ENTRY)


def sample_frame_codes_reference(hidden: torch.Tensor, weights: MagpieWeights,
                                 config: MagpieConfig, seed: int, temperature: float,
                                 top_k: int, forbid_eos: bool):
    """Plain PyTorch LT sampling: (sampled [8], argmax [8]) int32."""
    from ...models import local_transformer as lt_mod
    from .. import sampling

    static_mask = sampling.forbidden_token_mask(config.vocab_per_cb, config.audio_bos_id,
                                                device=hidden.device)
    return lt_mod.sample_frame_codes(hidden, weights, config, seed, temperature, top_k,
                                     forbid_eos, static_mask)


def sample_frame_codes(hidden: torch.Tensor, weights: MagpieWeights, config: MagpieConfig,
                       seed: int, temperature: float, top_k: int, forbid_eos: bool,
                       grid: Optional[int] = None, stamps: Optional[torch.Tensor] = None):
    """Sample one frame's 8 codes from ``hidden`` [d_model] with the frame's
    int32 ``seed``. Returns (sampled [8] int32, argmax [8] int32). ``grid``
    (tests only) launches that many blocks in place of the co-resident
    maximum; ``stamps`` (``frame_step.check_stamps``) receives the phase
    stamps of the launch."""
    global launches
    if hidden.device.type == "cpu":
        return sample_frame_codes_reference(hidden, weights, config, seed, temperature, top_k,
                                            forbid_eos)
    if hidden.device.type != "cuda":
        raise ValueError(f"sample_frame_codes: unsupported device {hidden.device}")
    c = config
    dtype = fs.compute_dtype(ENTRY, hidden)
    fs.check_config(ENTRY, c, top_k)
    dev = hidden.device
    sampled = torch.empty(c.num_codebooks, dtype=torch.int32, device=dev)
    argmax = torch.empty(c.num_codebooks, dtype=torch.int32, device=dev)
    tensors = {"hidden": (hidden, (c.d_model,)), **fs.lt_weight_tensors(weights, c)}
    fs.launch(fs.entry_name(ENTRY, dtype), tensors, dict(sampled=sampled, argmax=argmax), c, dev,
              dtype=dtype, grid=grid or 0, stamps=stamps,
              **fs.sampling_scalars(c, seed, temperature, top_k, forbid_eos))
    launches += 1
    fs.count_dtype(dtype_launches, dtype)
    return sampled, argmax
