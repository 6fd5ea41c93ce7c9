"""Kernel 5: the split path's decoder step for one stream.

``decode_step`` replaces the TPU kernel
magpie_tts_tpu/ops/pallas_kernels/decoder_step.py ``decode_step_pallas``
with its three weight streams (``stream``: None, an Int8DecoderStream or a
Q8DecoderStream, as for kernel A): the 12 cached decoder layers at one
position, from a frame embedding to which the position embedding is added
inside. On CUDA
tensors it launches the ``magpie_decode_step_f32`` / ``_bf16`` entry point
of csrc/frame_step.cu (kernel A's persistent kernel without its LT phases:
one cooperative launch, csrc/frame_persistent.cuh; x's dtype picks one) or
raises; on CPU tensors
it runs ``decode_step_reference``, the plain ``models.decoder.decode_step``.

Both write the new K/V row ``pos`` of every layer into the caches in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...config import MagpieConfig
from ...io.magpie_weights import MagpieWeights
from . import frame_step as fs

ENTRY = "magpie_decode_step"
launches = 0  # kernel launches (one per frame) since the last reset
mode_launches = dict.fromkeys(fs.MODES, 0)  # the same, by weight stream
dtype_launches = dict.fromkeys(("float32", "bfloat16"), 0)  # the same, by compute dtype


def declare(lib) -> None:
    fs.declare(lib, ENTRY)


def decode_step_reference(x: torch.Tensor, pos: int, xa_k: torch.Tensor, xa_v: torch.Tensor,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          weights: MagpieWeights, config: MagpieConfig,
                          enc_length: Optional[int] = None, stream=None) -> torch.Tensor:
    """Plain PyTorch decoder step: hidden [d_model]."""
    from ...models import decoder as decoder_mod

    return decoder_mod.decode_step(x, pos, xa_k, xa_v, k_cache, v_cache, weights, config,
                                   enc_length=enc_length, stream=stream)


def decode_step(x: torch.Tensor, pos: int, xa_k: torch.Tensor, xa_v: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor, weights: MagpieWeights,
                config: MagpieConfig, enc_length: Optional[int] = None,
                stream=None, grid: Optional[int] = None,
                stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decoder step: x [d_model] is the frame embedding WITHOUT the
    position embedding (added here: pos_emb[pos]); the new K/V row is written
    at ``pos`` of caches [L, max_seq, d_model] before attending to rows
    [0, pos]; xa_k / xa_v [L, enc, d_xa] with the first ``enc_length`` rows
    valid; ``stream`` supplies the four streamed matrices when given.
    ``grid`` and ``stamps`` as for ``frame_step.frame_step``. Returns hidden
    [d_model]."""
    global launches
    if x.device.type == "cpu":
        return decode_step_reference(x, pos, xa_k, xa_v, k_cache, v_cache, weights, config,
                                     enc_length, stream)
    if x.device.type != "cuda":
        raise ValueError(f"decode_step: unsupported device {x.device}")
    c = config
    dtype = fs.compute_dtype(ENTRY, x)
    fs.check_config(ENTRY, c)
    scalars = fs.step_scalars(ENTRY, c, pos, k_cache, xa_k, enc_length)
    hidden_out = torch.empty(c.d_model, dtype=dtype, device=x.device)
    tensors = {"hidden": (x, (c.d_model,)),
               "pos_emb": (weights.decoder.pos_emb, (c.max_pos, c.d_model)),
               **fs.cache_tensors(k_cache, v_cache, xa_k, xa_v, c),
               **fs.decoder_weight_tensors(weights, c, stream)}
    fs.launch(fs.entry_name(ENTRY, dtype), tensors, dict(hidden_out=hidden_out), c, x.device,
              stream, dtype, persistent=True, grid=grid or 0, stamps=stamps, **scalars)
    launches += 1
    mode_launches[fs.MODES[fs.stream_mode(stream)]] += 1
    fs.count_dtype(dtype_launches, dtype)
    return hidden_out
