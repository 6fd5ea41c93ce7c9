"""Kernel 8: the split path's decoder step for B slots.

``decode_step_batched`` replaces the TPU kernel
magpie_tts_tpu/ops/pallas_kernels/decoder_step_batched.py
``decode_step_batched_pallas`` with its three weight streams (``stream``:
None, an Int8DecoderStream or a Q8DecoderStream): the 12 cached decoder
layers for B slots that share one cache write row, each attending to the
rows its validity mask admits, every weight read once for all slots. On CUDA
tensors it launches the ``magpie_decode_step_batched_f32`` / ``_bf16`` entry
point of csrc/frame_step_batched.cu (kernel C's decoder sequence; x_pe's dtype
picks one) or raises; on CPU
tensors it runs ``decode_step_batched_reference``: per slot, the plain
``models.decoder.decode_rows``.

Any B >= 1, one launch (on the CPU, one plain call) a slot group of at most
64 (``frame_step_batched.slot_groups``): the TPU kernel's ``B % 8`` grouping
is a VMEM rule. Its half-prefix cache streaming becomes the host attention
bound ``rows``, as for kernel C.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from ...config import MagpieConfig
from ...io.magpie_weights import MagpieWeights
from . import frame_step_batched as fsb

ENTRY = "magpie_decode_step_batched"
launches = 0  # device launches (one a slot group) since the last reset
mode_launches = dict.fromkeys(fsb.MODES, 0)  # the same, by weight stream
dtype_launches = dict.fromkeys(("float32", "bfloat16"), 0)  # the same, by compute dtype
_launches_lock = threading.Lock()  # engines on several cards launch from a thread pool


def declare(lib) -> None:
    fsb.declare(lib, ENTRY)


def decode_step_batched_reference(x_pe: torch.Tensor, write_row: int, valid: torch.Tensor,
                                  xa_k: torch.Tensor, xa_v: torch.Tensor,
                                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                                  weights: MagpieWeights, config: MagpieConfig,
                                  enc_lengths: torch.Tensor,
                                  rows: Optional[int] = None, stream=None) -> torch.Tensor:
    """Plain PyTorch batched decoder step, one slot at a time. ``rows`` only
    bounds the kernel's attention window; rows past it must hold no valid
    row, so the plain version attends over the whole masked cache."""
    from ...models import decoder as decoder_mod

    del rows
    enc_l = enc_lengths.tolist()
    return torch.stack([
        decoder_mod.decode_rows(x_pe[b], write_row, valid[b].to(torch.bool), xa_k[b], xa_v[b],
                                k_cache[b], v_cache[b], weights, config,
                                enc_length=int(enc_l[b]), stream=stream)
        for b in range(x_pe.shape[0])])


def decode_step_batched(x_pe: torch.Tensor, write_row: int, valid: torch.Tensor,
                        xa_k: torch.Tensor, xa_v: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, weights: MagpieWeights, config: MagpieConfig,
                        enc_lengths: torch.Tensor, rows: Optional[int] = None,
                        stream=None) -> torch.Tensor:
    """One decoder step for B slots.

    x_pe [B, d_model]: frame embeddings WITH their position embeddings;
    valid [B, max_seq] bool (a broadcast [S] row is fine) marks the rows each
    slot attends to and must already hold ``write_row`` for live slots;
    caches [B, L, max_seq, d_model] take the new K/V row at ``write_row`` for
    every slot (in place); xa_k / xa_v [B, L, enc, d_xa]; enc_lengths [B]
    int32. ``rows`` (host int, default max_seq) bounds self-attention to rows
    [0, rows): no valid row may lie past it. ``stream`` supplies the four
    streamed decoder matrices when given. Any B >= 1: one launch a slot
    group. Returns hidden [B, d_model].
    """
    c = config
    dev = x_pe.device
    B, S = k_cache.shape[0], k_cache.shape[2]
    groups = fsb.slot_groups(B)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_step_batched: unsupported device {dev}")
    per_slot = dict(x_pe=x_pe, valid=valid, xa_k=xa_k, xa_v=xa_v, k_cache=k_cache,
                    v_cache=v_cache, enc_lengths=enc_lengths)
    hidden_out = torch.empty(B, c.d_model, dtype=x_pe.dtype, device=dev)
    if dev.type == "cuda":
        dtype = fsb.compute_dtype(ENTRY, x_pe)
        rows = fsb.check_rows(ENTRY, c, write_row, rows, S)
        fsb.check_config(ENTRY, c)

    def plain(**g):
        return (decode_step_batched_reference(write_row=write_row, weights=weights, config=c,
                                              rows=rows, stream=stream, **g),)

    def kernel(g, o, n):
        global launches
        tensors = {"hidden": (g["x_pe"], (n, c.d_model), dtype, False),
                   **fsb.decoder_tensors(g["valid"], g["enc_lengths"], g["k_cache"],
                                         g["v_cache"], g["xa_k"], g["xa_v"], weights, c, stream,
                                         dtype)}
        fsb.launch(fsb.entry_name(ENTRY, dtype), n, tensors, o, c, dev, stream, max_seq=S,
                   enc_rows=xa_k.shape[2], write_row=int(write_row), rows=rows,
                   valid_stride=valid.stride(0))
        with _launches_lock:
            launches += 1
            mode_launches[fsb.MODES[fsb.stream_mode(stream)]] += 1
            fsb.count_dtype(dtype_launches, dtype)

    fsb.run_groups(groups, per_slot, dict(hidden_out=hidden_out), plain, kernel)
    return hidden_out
    dtype = fsb.compute_dtype(ENTRY, x_pe)
    rows = fsb.check_rows(ENTRY, c, write_row, rows, S)
    fsb.check_config(ENTRY, c)
    for a, b in groups:
        g = fsb.slot_group(per_slot, a, b)
        tensors = {"hidden": (g["x_pe"], (b - a, c.d_model), dtype, False),
                   **fsb.decoder_tensors(g["valid"], g["enc_lengths"], g["k_cache"],
                                         g["v_cache"], g["xa_k"], g["xa_v"], weights, c, stream,
                                         dtype)}
        fsb.launch(fsb.entry_name(ENTRY, dtype), b - a, tensors,
                   dict(hidden_out=hidden_out[a:b]), c, dev, stream, max_seq=S,
                   enc_rows=xa_k.shape[2], write_row=int(write_row), rows=rows,
                   valid_stride=valid.stride(0))
        with _launches_lock:
            launches += 1
            mode_launches[fsb.MODES[fsb.stream_mode(stream)]] += 1
            fsb.count_dtype(dtype_launches, dtype)
    return hidden_out
