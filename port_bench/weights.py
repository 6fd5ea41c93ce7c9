"""Random weights at the configuration's widths, made on the device.

One flat dict per model, keyed by field path (``"decoder.qkv"``,
``"stages.0.resblocks.1.2.in_conv_w"``), every tensor a view into one
buffer drawn by a seeded ``torch.Generator`` in two calls (normal and
uniform), scaled per kind in one call each and cast to the served dtype in
one more. Scales: matrices and embeddings N(0, 0.02), LayerNorm gains
1 + N(0, 0.05), codec convolutions N(0, 0.1), Snake alphas 0.5 + U(0.1, 1).
Each tensor starts on a 256-byte boundary, as the kernels' vector loads want.
The same dict goes to the program (wrapped in its containers, no copy) and,
widened, to the reference.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

ALIGN = 128  # elements: 256 bytes in bfloat16, 512 in float32


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``seed`` (any size of int)."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def magpie_shapes(hp: dict) -> List[Tuple[str, tuple, str]]:
    """(key, shape, kind) of every Magpie tensor; kind "w" (0.02) or "g" (gain)."""
    D, Fd, L, E = hp["d_model"], hp["d_ffn"], hp["dec_layers"], hp["enc_layers"]
    k, dxa, lt, ltf = hp["enc_kernel"], hp["dec_xa_heads"] * hp["dec_xa_d_head"], hp["lt_dim"], \
        hp["lt_ffn_dim"]
    cb, V = hp["num_codebooks"], hp["vocab_per_cb"]
    return [
        ("encoder.pos_emb", (hp["max_pos"], D), "w"),
        ("encoder.norm_self", (E, D), "g"),
        ("encoder.qkv", (E, D, 3 * D), "w"),
        ("encoder.sa_out", (E, D, D), "w"),
        ("encoder.norm_ff", (E, D), "g"),
        ("encoder.ff_proj", (E, k, D, Fd), "w"),
        ("encoder.ff_out", (E, k, Fd, D), "w"),
        ("encoder.norm_out", (D,), "g"),
        ("decoder.pos_emb", (hp["max_pos"], D), "w"),
        ("decoder.norm_self", (L, D), "g"),
        ("decoder.qkv", (L, D, 3 * D), "w"),
        ("decoder.sa_out", (L, D, D), "w"),
        ("decoder.norm_xa_q", (L, D), "g"),
        ("decoder.norm_xa_mem", (L, D), "g"),
        ("decoder.xa_q", (L, D, dxa), "w"),
        ("decoder.xa_kv", (L, D, 2 * dxa), "w"),
        ("decoder.xa_out", (L, dxa, D), "w"),
        ("decoder.norm_ff", (L, D), "g"),
        ("decoder.ff_proj", (L, D, Fd), "w"),
        ("decoder.ff_out", (L, Fd, D), "w"),
        ("decoder.norm_out", (D,), "g"),
        ("lt.in_proj_w", (D, lt), "w"),
        ("lt.in_proj_b", (lt,), "w"),
        ("lt.pos_emb", (hp["lt_max_pos"], lt), "w"),
        ("lt.norm_self", (lt,), "g"),
        ("lt.qkv", (lt, 3 * lt), "w"),
        ("lt.sa_out", (lt, lt), "w"),
        ("lt.norm_ff", (lt,), "g"),
        ("lt.ff_proj", (lt, ltf), "w"),
        ("lt.ff_out", (ltf, lt), "w"),
        ("lt.out_proj_w", (cb, lt, V), "w"),
        ("lt.out_proj_b", (cb, V), "w"),
        ("text_emb", (hp["text_vocab_size"], D), "w"),
        ("audio_emb", (cb, V, D), "w"),
        ("baked_context", (hp["num_speakers"], hp["context_frames"], D), "w"),
        ("final_proj_w", (D, cb * V), "w"),
        ("final_proj_b", (cb * V,), "w"),
    ]


def codec_shapes(hp: dict) -> List[Tuple[str, tuple, str]]:
    """(key, shape, kind) of every codec tensor; kind "c" (0.1) or "a" (alpha)."""
    out = []
    ups = hp["up_channels"]
    in_chs = (hp["base_channels"],) + tuple(ups[:-1])
    for i, (cin, cout, kup) in enumerate(zip(in_chs, ups, hp["up_kernels"])):
        sp = f"stages.{i}."
        for j, ks in enumerate(hp["resblock_kernel_sizes"]):
            for d in range(len(hp["resblock_dilations"])):
                bp = f"{sp}resblocks.{j}.{d}."
                out += [(bp + "in_alpha", (cout // 2,), "a"),
                        (bp + "in_conv_w", (ks, cout, cout), "c"),
                        (bp + "in_conv_b", (cout,), "c"),
                        (bp + "sk_alpha", (cout // 2,), "a"),
                        (bp + "sk_conv_w", (ks, cout, cout), "c"),
                        (bp + "sk_conv_b", (cout,), "c")]
        out += [(sp + "act_alpha", (cin // 2,), "a"), (sp + "convt_w", (cin, kup), "c"),
                (sp + "convt_b", (cout,), "c")]
    out += [("pre_conv_w", (hp["pre_conv_kernel"], hp["latent_dim"], hp["base_channels"]), "c"),
            ("pre_conv_b", (hp["base_channels"],), "c"),
            ("post_alpha", (ups[-1] // 2,), "a"),
            ("post_conv_w", (hp["post_conv_kernel"], ups[-1], 1), "c"),
            ("post_conv_b", (1,), "c")]
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


_SCALE = {"w": (0.02, 0.0), "g": (0.05, 1.0), "c": (0.1, 0.0), "a": (0.9, 0.6)}


def make(shapes, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The tensors of ``shapes`` from ``seed``: normal kinds ("w" 0.02, "g"
    1 + 0.05 z, "c" 0.1) from one draw, uniform kinds ("a": 0.6 + 0.9 u) from
    another. Tensors of one kind lie side by side, so each kind is scaled
    by one call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for kinds, draw in (("wgc", torch.randn), ("a", torch.rand)):
        group = sorted((s for s in shapes if s[2] in kinds), key=lambda s: kinds.index(s[2]))
        if not group:
            continue
        offsets, total, runs = [], 0, {}
        for _, shape, kind in group:
            offsets.append(total)
            total += -(-_numel(shape) // ALIGN) * ALIGN
            runs[kind] = (runs.get(kind, (offsets[-1],))[0], total)
        buf = draw(total, generator=gen, device=device, dtype=torch.float32)
        for kind, (a, b) in runs.items():
            scale, shift = _SCALE[kind]
            buf[a:b].mul_(scale).add_(shift)
        buf = buf.to(dtype)
        for (key, shape, _), off in zip(group, offsets):
            out[key] = buf[off:off + _numel(shape)].view(shape)
    return out
