"""What the benchmark takes from the program under test, ``magpie_tts_tpu_torch``,
beside the engines the drivers build and the kernel wrappers the rooflines
name: its configuration types and its weight containers, filled with the
benchmark's own tensors (no copy).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from magpie_tts_tpu_torch.config import CodecConfig, MagpieConfig
from magpie_tts_tpu_torch.io.codec_weights import (CodecWeights, ResBlockWeights,
                                                   UpsampleStageWeights)
from magpie_tts_tpu_torch.io.magpie_weights import (DecoderWeights, EncoderWeights,
                                                    LocalTransformerWeights, MagpieWeights)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def configs(model: dict):
    """(MagpieConfig, CodecConfig) from a configuration file's ``magpie`` and
    ``codec`` groups (every field the file gives; lists become tuples)."""
    def build(cls, values):
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in values.items() if k in names}
        return cls(**kw)
    return build(MagpieConfig, model["magpie"]), build(CodecConfig, model["codec"])


def magpie_weights(raw: Dict[str, torch.Tensor]) -> MagpieWeights:
    def build(cls, prefix):
        return cls(**{f.name: raw[prefix + f.name] for f in dataclasses.fields(cls)})
    parts = {"encoder": build(EncoderWeights, "encoder."),
             "decoder": build(DecoderWeights, "decoder."),
             "lt": build(LocalTransformerWeights, "lt.")}
    top = {f.name: raw[f.name] for f in dataclasses.fields(MagpieWeights) if f.name not in parts}
    return MagpieWeights(**top, **parts)


def codec_weights(raw: Dict[str, torch.Tensor], hp: dict) -> CodecWeights:
    n_k, n_d = len(hp["resblock_kernel_sizes"]), len(hp["resblock_dilations"])

    def fields(cls, prefix):
        return {f.name: raw[prefix + f.name] for f in dataclasses.fields(cls)
                if f.name != "resblocks"}

    stages = []
    for i in range(len(hp["up_sample_rates"])):
        sp = f"stages.{i}."
        blocks = tuple(tuple(ResBlockWeights(**fields(ResBlockWeights, f"{sp}resblocks.{j}.{d}."))
                             for d in range(n_d)) for j in range(n_k))
        stages.append(UpsampleStageWeights(resblocks=blocks, **fields(UpsampleStageWeights, sp)))
    return CodecWeights(pre_conv_w=raw["pre_conv_w"], pre_conv_b=raw["pre_conv_b"],
                        stages=tuple(stages), post_alpha=raw["post_alpha"],
                        post_conv_w=raw["post_conv_w"], post_conv_b=raw["post_conv_b"])


def load_kernels(device) -> None:
    """Build (first run in a checkout) or load the program's kernel library."""
    if torch.device(device).type == "cuda":
        from magpie_tts_tpu_torch.ops.kernels import build

        build.load_library()
