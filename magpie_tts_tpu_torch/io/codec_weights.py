"""Nano-codec decoder weight containers + GGUF loading + synthetic init.

GGUF tensor names and layouts follow the JAX package
(magpie_tts_tpu/io/codec_weights.py): conv weights stored PyTorch-shaped
``[out, in, k]`` are transposed to WIO ``[k, in, out]``; the grouped
ConvTranspose weight ``[in_ch, 1, K]`` is squeezed to ``[in_ch, K]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import CodecConfig
from .gguf import GGUFReader
from .tree import flatten_tensors, map_tensors


@dataclasses.dataclass(frozen=True)
class ResBlockWeights:
    """One inner residual block (in-act -> dilated conv -> skip-act -> conv)."""
    in_alpha: torch.Tensor    # [ch//2]
    in_conv_w: torch.Tensor   # [k, ch, ch]
    in_conv_b: torch.Tensor   # [ch]
    sk_alpha: torch.Tensor    # [ch//2]
    sk_conv_w: torch.Tensor   # [k, ch, ch]
    sk_conv_b: torch.Tensor   # [ch]


@dataclasses.dataclass(frozen=True)
class UpsampleStageWeights:
    act_alpha: torch.Tensor   # [in_ch//2] HalfSnake before the upsample
    convt_w: torch.Tensor     # [in_ch, K] grouped ConvTranspose1d
    convt_b: torch.Tensor     # [out_ch]
    # res layer: 3 kernel branches x 3 dilation blocks
    resblocks: Tuple[Tuple[ResBlockWeights, ...], ...]


@dataclasses.dataclass(frozen=True)
class CodecWeights:
    pre_conv_w: torch.Tensor   # [7, latent_dim, base_ch]
    pre_conv_b: torch.Tensor   # [base_ch]
    stages: Tuple[UpsampleStageWeights, ...]  # 5 stages
    post_alpha: torch.Tensor   # [final_ch//2]
    post_conv_w: torch.Tensor  # [3, final_ch, 1]
    post_conv_b: torch.Tensor  # [1]

    def to(self, device=None, dtype=None) -> "CodecWeights":
        return map_tensors(self, lambda t: t.to(device=device, dtype=dtype))

    def flatten(self) -> Dict[str, torch.Tensor]:
        return flatten_tensors(self)


def _count(arrays: Mapping[str, np.ndarray], prefix: str) -> int:
    n = 0
    while any(k.startswith(f"{prefix}{n}.") for k in arrays):
        n += 1
    return n


def codec_weights_from_numpy(arrays: Mapping[str, np.ndarray],
                             dtype=torch.float32) -> CodecWeights:
    """Build CodecWeights from ``{field.path: array}`` with tuple indices in
    the path (``"stages.0.resblocks.1.2.in_conv_w"``, ``"pre_conv_w"``)."""
    used = set()

    def take(key):
        used.add(key)
        return torch.as_tensor(np.array(arrays[key]), dtype=dtype)

    def fields(cls, prefix):
        return {f.name: take(prefix + f.name) for f in dataclasses.fields(cls)
                if f.name != "resblocks"}

    stages = []
    for i in range(_count(arrays, "stages.")):
        sp = f"stages.{i}."
        branches = tuple(
            tuple(ResBlockWeights(**fields(ResBlockWeights, f"{sp}resblocks.{j}.{k}."))
                  for k in range(_count(arrays, f"{sp}resblocks.{j}.")))
            for j in range(_count(arrays, f"{sp}resblocks.")))
        stages.append(UpsampleStageWeights(resblocks=branches,
                                           **fields(UpsampleStageWeights, sp)))
    weights = CodecWeights(
        pre_conv_w=take("pre_conv_w"), pre_conv_b=take("pre_conv_b"),
        stages=tuple(stages), post_alpha=take("post_alpha"),
        post_conv_w=take("post_conv_w"), post_conv_b=take("post_conv_b"))
    extra = set(arrays) - used
    if extra:
        raise KeyError(f"unknown weight keys: {sorted(extra)}")
    return weights


def _wio(x: np.ndarray) -> np.ndarray:
    """PyTorch conv weight [out, in, k] -> WIO [k, in, out]."""
    return np.ascontiguousarray(np.transpose(x, (2, 1, 0)))


def load_codec_weights(path: str, config: Optional[CodecConfig] = None,
                       dtype=torch.float32, reader: Optional[GGUFReader] = None):
    if reader is None:
        reader = GGUFReader(path)
    if config is None:
        config = CodecConfig.from_gguf_metadata(reader.metadata)
    get = reader.tensor

    def alpha(name):
        return get(name).reshape(-1)  # stored [1, C/2, 1]

    arrays = {"pre_conv_w": _wio(get("dec.pre.weight")),
              "pre_conv_b": get("dec.pre.bias")}
    for i in range(len(config.up_sample_rates)):
        sp = f"stages.{i}."
        arrays[sp + "act_alpha"] = alpha(f"dec.act.{i}.activation.snake_act.alpha")
        arrays[sp + "convt_w"] = np.ascontiguousarray(get(f"dec.up.{i}.c.weight")[:, 0, :])
        arrays[sp + "convt_b"] = get(f"dec.up.{i}.c.bias")
        for j in range(len(config.resblock_kernel_sizes)):
            for k in range(len(config.resblock_dilations)):
                p = f"dec.rl.{i}.rb.{j}.rb.{k}"
                bp = f"{sp}resblocks.{j}.{k}."
                arrays[bp + "in_alpha"] = alpha(f"{p}.in_act.alpha")
                arrays[bp + "in_conv_w"] = _wio(get(f"{p}.in_conv.weight"))
                arrays[bp + "in_conv_b"] = get(f"{p}.in_conv.bias")
                arrays[bp + "sk_alpha"] = alpha(f"{p}.sk_act.alpha")
                arrays[bp + "sk_conv_w"] = _wio(get(f"{p}.sk_conv.weight"))
                arrays[bp + "sk_conv_b"] = get(f"{p}.sk_conv.bias")
    arrays["post_alpha"] = alpha("dec.post_act.alpha")
    arrays["post_conv_w"] = _wio(get("dec.post.weight"))
    arrays["post_conv_b"] = get("dec.post.bias")
    return config, codec_weights_from_numpy(arrays, dtype=dtype)


def random_codec_weights(config: CodecConfig, seed: int = 0,
                         dtype=torch.float32) -> CodecWeights:
    """Synthetic weights drawn from ``np.random.default_rng(seed)`` in the JAX
    package's order (magpie_tts_tpu/io/codec_weights.py random_codec_weights):
    per stage the 3x3 res blocks first, then the stage's alpha / convT."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.1):
        return rng.normal(0.0, scale, size=shape).astype(np.float32)

    def a(n):
        return (0.5 + rng.uniform(0.1, 1.0, size=(n,))).astype(np.float32)

    arrays = {}
    in_chs = (config.base_channels,) + config.up_channels[:-1]
    for i, (in_ch, out_ch, k_up) in enumerate(
            zip(in_chs, config.up_channels, config.up_kernels)):
        sp = f"stages.{i}."
        for j, ksize in enumerate(config.resblock_kernel_sizes):
            for k in range(len(config.resblock_dilations)):
                bp = f"{sp}resblocks.{j}.{k}."
                arrays[bp + "in_alpha"] = a(out_ch // 2)
                arrays[bp + "in_conv_w"] = w(ksize, out_ch, out_ch)
                arrays[bp + "in_conv_b"] = w(out_ch)
                arrays[bp + "sk_alpha"] = a(out_ch // 2)
                arrays[bp + "sk_conv_w"] = w(ksize, out_ch, out_ch)
                arrays[bp + "sk_conv_b"] = w(out_ch)
        arrays[sp + "act_alpha"] = a(in_ch // 2)
        arrays[sp + "convt_w"] = w(in_ch, k_up)
        arrays[sp + "convt_b"] = w(out_ch)
    arrays["pre_conv_w"] = w(config.pre_conv_kernel, config.latent_dim,
                             config.base_channels)
    arrays["pre_conv_b"] = w(config.base_channels)
    arrays["post_alpha"] = a(config.up_channels[-1] // 2)
    arrays["post_conv_w"] = w(config.post_conv_kernel, config.up_channels[-1], 1)
    arrays["post_conv_b"] = w(1)
    return codec_weights_from_numpy(arrays, dtype=dtype)
