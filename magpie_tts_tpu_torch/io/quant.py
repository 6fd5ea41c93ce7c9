"""Block quantization (Q8_0 / Q4_0) — numpy codecs, and the Q8_0 block split
that keeps a checkpoint's own int8 values and scales for serving.

Block layout matches the reference converter exactly
(scripts/convert_magpie_to_gguf.py:79-138): 32-element blocks, each block is a
little-endian f16 scale followed by the quantized values (int8 for Q8_0; 16 packed
nibble-pair bytes for Q4_0, low nibble = element i, high nibble = element i+16,
stored biased by +8).
"""

from __future__ import annotations

import numpy as np

QK = 32


def quantize_q8_0(data: np.ndarray) -> bytes:
    flat = np.ascontiguousarray(data, dtype=np.float32).reshape(-1)
    n = flat.size
    if n % QK:
        flat = np.pad(flat, (0, QK - n % QK))
    blocks = flat.reshape(-1, QK)
    amax = np.max(np.abs(blocks), axis=1)
    scales = np.where(amax != 0, amax / 127.0, 0.0).astype(np.float16)
    s32 = scales.astype(np.float32)[:, None]
    q = np.round(blocks / np.where(s32 != 0, s32, 1.0)).astype(np.int8)
    q = np.where(s32 != 0, q, 0).astype(np.int8)
    out = np.empty(len(blocks), dtype=np.dtype([("scale", np.float16), ("quants", np.int8, QK)]))
    out["scale"] = scales
    out["quants"] = q
    return out.tobytes()


def dequantize_q8_0(payload: np.ndarray, n_elements: int) -> np.ndarray:
    blocks = payload.view(np.dtype([("scale", np.float16), ("quants", np.int8, QK)]))
    vals = blocks["quants"].astype(np.float32) * blocks["scale"].astype(np.float32)[:, None]
    return vals.reshape(-1)[:n_elements]


def quantize_q4_0(data: np.ndarray) -> bytes:
    flat = np.ascontiguousarray(data, dtype=np.float32).reshape(-1)
    n = flat.size
    if n % QK:
        flat = np.pad(flat, (0, QK - n % QK))
    blocks = flat.reshape(-1, QK)
    amax = np.max(np.abs(blocks), axis=1)
    scales = np.where(amax != 0, amax / 7.0, 0.0).astype(np.float16)
    s32 = scales.astype(np.float32)[:, None]
    q = np.round(blocks / np.where(s32 != 0, s32, 1.0)).astype(np.int8)
    q = np.clip(q, -8, 7)
    q = np.where(s32 != 0, q, 0)
    qu = (q + 8).astype(np.uint8)
    packed = (qu[:, : QK // 2] & 0x0F) | ((qu[:, QK // 2:] & 0x0F) << 4)
    out = np.empty(len(blocks), dtype=np.dtype([("scale", np.float16), ("quants", np.uint8, QK // 2)]))
    out["scale"] = scales
    out["quants"] = packed.astype(np.uint8)
    return out.tobytes()


def dequantize_q4_0(payload: np.ndarray, n_elements: int) -> np.ndarray:
    blocks = payload.view(np.dtype([("scale", np.float16), ("quants", np.uint8, QK // 2)]))
    packed = blocks["quants"]
    low = (packed & 0x0F).astype(np.int8) - 8
    high = (packed >> 4).astype(np.int8) - 8
    q = np.concatenate([low, high], axis=1).astype(np.float32)
    vals = q * blocks["scale"].astype(np.float32)[:, None]
    return vals.reshape(-1)[:n_elements]


def split_q8_0(payload: np.ndarray, n_elements: int):
    """Split a raw Q8_0 payload into (int8 values [n_blocks, 32], f32 scales
    [n_blocks]): the blocks as stored, for serving them without dequantizing
    at load (io.magpie_weights.Q8DecoderStream, Q8Blocks)."""
    blocks = payload.view(np.dtype([("scale", np.float16), ("quants", np.int8, QK)]))
    n_blocks = n_elements // QK
    return blocks["quants"][:n_blocks].copy(), blocks["scale"][:n_blocks].astype(np.float32)
