"""Model hyperparameters.

Defaults are the Magpie TTS Multilingual 357M configuration. The reference engine
effectively hardcodes these too: its converter writes different GGUF key names than
its loader reads, so struct defaults are authoritative (reference src/magpie.cpp:73-121
vs scripts/convert_magpie_to_gguf.py:210-235). We read BOTH key spellings, then fall
back to these defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class MagpieConfig:
    # Model dimensions (reference src/magpie.h:35-80)
    d_model: int = 768
    d_ffn: int = 3072
    d_head: int = 64

    # Text encoder
    enc_layers: int = 6
    enc_heads: int = 12
    enc_kernel: int = 3

    # Main decoder
    dec_layers: int = 12
    dec_sa_heads: int = 12
    dec_xa_heads: int = 1
    dec_xa_d_head: int = 128
    dec_kernel: int = 1

    # Local transformer
    lt_dim: int = 256
    lt_ffn_dim: int = 1024
    lt_layers: int = 1
    lt_heads: int = 1
    lt_max_pos: int = 10  # position-embedding table rows (8 codebooks + margin)

    # Vocabulary
    text_vocab_size: int = 2380
    num_codebooks: int = 8
    codebook_size: int = 2016
    vocab_per_cb: int = 2024

    # Baked speaker context
    num_speakers: int = 5
    context_frames: int = 110

    # Special tokens (reference src/magpie.h:69-74)
    text_bos_id: int = 2378
    text_eos_id: int = 2379
    audio_bos_id: int = 2016
    audio_eos_id: int = 2017
    context_bos_id: int = 2018
    context_eos_id: int = 2019
    mask_token_id: int = 2020

    # GELU flavor for every conv-FFN in the model: "erf" (exact, what the NeMo
    # checkpoint was trained/validated with) or "tanh" (the ggml approximation
    # the reference C++ engine computes, src/magpie.cpp:1791-1805 via ggml_gelu).
    # One flag flips every FFN in every path — XLA oracle, all Pallas kernels,
    # and the torch test oracle — so A/B parity runs against a C++ dump are a
    # config switch, not a source edit. CLI: --gelu {erf,tanh}.
    gelu_flavor: str = "erf"

    # Inference
    max_dec_steps: int = 500
    min_generated_frames: int = 4  # EOS forbidden before this (magpie.cpp:2687)
    sample_rate: int = 22050
    eps: float = 1e-5

    # Position-embedding tables in the checkpoint are [4096, d_model]
    max_pos: int = 4096

    def __post_init__(self):
        if self.gelu_flavor not in ("erf", "tanh"):
            raise ValueError(
                f"gelu_flavor must be 'erf' or 'tanh', got {self.gelu_flavor!r}")

    @property
    def gelu_tanh(self) -> bool:
        """True when every FFN should use the ggml tanh GELU approximation."""
        return self.gelu_flavor == "tanh"

    @property
    def d_xa(self) -> int:
        return self.dec_xa_heads * self.dec_xa_d_head

    @property
    def max_seq(self) -> int:
        """KV-cache capacity: context + max decode steps + margin (magpie.cpp:3545),
        rounded up to a multiple of 16 (TPU sublane tiling for f32 AND bf16
        caches; extra slots are masked out by the length mask)."""
        n = self.context_frames + self.max_dec_steps + 16
        return (n + 15) // 16 * 16

    @classmethod
    def from_gguf_metadata(cls, kv: Mapping[str, object]) -> "MagpieConfig":
        """Build a config from GGUF metadata, tolerating both key spellings.

        The reference reader looks for e.g. ``magpie.enc_layers`` (magpie.cpp:89)
        while the converter writes ``magpie.encoder_layers``
        (convert_magpie_to_gguf.py:219). Accept both.
        """
        alias = {
            "enc_layers": ("magpie.enc_layers", "magpie.encoder_layers"),
            "dec_layers": ("magpie.dec_layers", "magpie.decoder_layers"),
            "enc_heads": ("magpie.enc_heads", "magpie.encoder_heads"),
            "dec_sa_heads": ("magpie.dec_sa_heads", "magpie.decoder_sa_heads"),
            "dec_xa_heads": ("magpie.dec_xa_heads", "magpie.decoder_xa_heads"),
            "dec_xa_d_head": ("magpie.dec_xa_d_head",),
            "lt_dim": ("magpie.lt_dim", "magpie.local_transformer_dim"),
            "lt_ffn_dim": ("magpie.lt_ffn_dim",),
            "lt_layers": ("magpie.lt_layers", "magpie.local_transformer_layers"),
            "lt_heads": ("magpie.lt_heads",),
            "num_speakers": ("magpie.num_speakers", "magpie.num_baked_speakers"),
            "context_frames": ("magpie.context_frames", "magpie.baked_context_frames"),
            "vocab_per_cb": ("magpie.vocab_per_cb", "magpie.vocab_size_per_codebook"),
        }
        updates = {}
        for field in dataclasses.fields(cls):
            keys = alias.get(field.name, (f"magpie.{field.name}",))
            for key in keys:
                if key in kv:
                    updates[field.name] = type(field.default)(kv[key])
                    break
        return cls(**updates)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """NeMo nano-codec decoder config (reference src/magpie.h:655-678)."""

    sample_rate: int = 22050
    num_codebooks: int = 8
    codebook_size: int = 2016
    hop_length: int = 1024
    latent_dim: int = 32  # 8 codebooks x 4 dims

    fsq_levels: tuple = (8, 7, 6, 6)
    fsq_dim_base: tuple = (1, 8, 56, 336)  # cumulative products of levels

    pre_conv_kernel: int = 7
    post_conv_kernel: int = 3
    base_channels: int = 864

    up_sample_rates: tuple = (8, 8, 4, 2, 2)  # product == hop_length
    up_channels: tuple = (432, 216, 108, 54, 27)
    up_kernels: tuple = (16, 16, 8, 4, 4)  # 2x stride (docs/CODEC_ARCHITECTURE.md:109-118)

    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilations: tuple = (1, 3, 5)

    leaky_slope: float = 0.01  # validated value (nano-codec.cpp:417)

    @classmethod
    def from_gguf_metadata(cls, kv: Mapping[str, object]) -> "CodecConfig":
        updates = {}
        for field in dataclasses.fields(cls):
            key = f"codec.{field.name}"
            if key in kv and not isinstance(field.default, tuple):
                updates[field.name] = type(field.default)(kv[key])
        # Per-stage structure, written as codec.<name>_{i} scalars by our own
        # converter (the reference converter omits them; defaults cover the
        # production model).
        for name in ("up_sample_rates", "up_channels", "up_kernels"):
            if f"codec.{name}_0" in kv:
                vals = []
                i = 0
                while f"codec.{name}_{i}" in kv:
                    vals.append(int(kv[f"codec.{name}_{i}"]))
                    i += 1
                updates[name] = tuple(vals)
        return cls(**updates)
