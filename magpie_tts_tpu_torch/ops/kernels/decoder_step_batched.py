"""Kernel 8: the split path's decoder step for B slots.

``decode_step_batched`` replaces the TPU kernel
magpie_tts_tpu/ops/pallas_kernels/decoder_step_batched.py
``decode_step_batched_pallas`` (dense float32 stream): the 12 cached decoder
layers for B slots that share one cache write row, each attending to the
rows its validity mask admits, every weight read once for all slots. On CUDA
tensors it launches the ``magpie_decode_step_batched_f32`` entry point of
csrc/frame_step_batched.cu (kernel C's decoder sequence) or raises; on CPU
tensors it runs ``decode_step_batched_reference``: per slot, the plain
``models.decoder.decode_rows``.

Any 1 <= B <= 64: the TPU kernel's ``B % 8`` grouping is a VMEM rule. Its
half-prefix cache streaming becomes the host attention bound ``rows``, as for
kernel C.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from ...config import MagpieConfig
from ...io.magpie_weights import MagpieWeights
from . import frame_step_batched as fsb

ENTRY = "magpie_decode_step_batched_f32"
launches = 0  # kernel launches (one per frame) since the last reset
_launches_lock = threading.Lock()  # engines on several cards launch from a thread pool


def declare(lib) -> None:
    fsb.declare(lib, ENTRY)


def decode_step_batched_reference(x_pe: torch.Tensor, write_row: int, valid: torch.Tensor,
                                  xa_k: torch.Tensor, xa_v: torch.Tensor,
                                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                                  weights: MagpieWeights, config: MagpieConfig,
                                  enc_lengths: torch.Tensor,
                                  rows: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch batched decoder step, one slot at a time. ``rows`` only
    bounds the kernel's attention window; rows past it must hold no valid
    row, so the plain version attends over the whole masked cache."""
    from ...models import decoder as decoder_mod

    del rows
    enc_l = enc_lengths.tolist()
    return torch.stack([
        decoder_mod.decode_rows(x_pe[b], write_row, valid[b].to(torch.bool), xa_k[b], xa_v[b],
                                k_cache[b], v_cache[b], weights, config,
                                enc_length=int(enc_l[b]))
        for b in range(x_pe.shape[0])])


def decode_step_batched(x_pe: torch.Tensor, write_row: int, valid: torch.Tensor,
                        xa_k: torch.Tensor, xa_v: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, weights: MagpieWeights, config: MagpieConfig,
                        enc_lengths: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """One decoder step for B slots.

    x_pe [B, d_model]: frame embeddings WITH their position embeddings;
    valid [B, max_seq] bool (a broadcast [S] row is fine) marks the rows each
    slot attends to and must already hold ``write_row`` for live slots;
    caches [B, L, max_seq, d_model] take the new K/V row at ``write_row`` for
    every slot (in place); xa_k / xa_v [B, L, enc, d_xa]; enc_lengths [B]
    int32. ``rows`` (host int, default max_seq) bounds self-attention to rows
    [0, rows): no valid row may lie past it. Returns hidden [B, d_model].
    """
    global launches
    if x_pe.device.type == "cpu":
        return decode_step_batched_reference(x_pe, write_row, valid, xa_k, xa_v, k_cache,
                                             v_cache, weights, config, enc_lengths, rows)
    if x_pe.device.type != "cuda":
        raise ValueError(f"decode_step_batched: unsupported device {x_pe.device}")
    c = config
    B, S = k_cache.shape[0], k_cache.shape[2]
    fsb.check_batch(ENTRY, B)
    rows = fsb.check_rows(ENTRY, c, write_row, rows, S)
    fsb.check_config(ENTRY, c)
    hidden_out = torch.empty(B, c.d_model, dtype=torch.float32, device=x_pe.device)
    tensors = {"hidden": (x_pe, (B, c.d_model), torch.float32, False),
               **fsb.decoder_tensors(valid, enc_lengths, k_cache, v_cache, xa_k, xa_v, weights,
                                     c)}
    fsb.launch(ENTRY, B, tensors, dict(hidden_out=hidden_out), c, x_pe.device, max_seq=S,
               enc_rows=xa_k.shape[2], write_row=int(write_row), rows=rows,
               valid_stride=valid.stride(0))
    with _launches_lock:
        launches += 1
    return hidden_out
