"""The nano-codec decoder (nvidia/nemo-nano-codec-22khz-1.89kbps-21.5fps)
written out plainly in PyTorch: FSQ codes to latents, then a causal
HiFi-GAN: a pre-conv, five stages of (HalfSnake, grouped transposed conv
upsampling, a residual layer that averages three branches of three dilated
blocks), a HalfSnake post-conv and tanh. 1024 samples a frame at 22050 Hz.

Convolutions are causal (left padding). Float32 with TF32 off; the control's
precisions as in ``reference.model``. Weights: the benchmark's flat dict
(``"stages.0.resblocks.1.2.in_conv_w"`` [k, in, out], ...).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .model import fp8_round, precision_flags


class Codec:
    def __init__(self, raw: Dict[str, torch.Tensor], hp: dict, device,
                 precision: str = "float32"):
        self.hp = hp
        self.precision = precision
        self.w = {}
        for k, v in raw.items():
            t = v.to(device=device, dtype=torch.float32)
            if precision == "fp8" and k.endswith("_w"):
                t = fp8_round(t)
            self.w[k] = t

    def conv(self, x, w, b, dilation=1):
        """x [N, C, T]; w [k, in, out] -> causal conv + bias."""
        k = w.shape[0]
        if self.precision == "fp8":
            x = fp8_round(x)
        x = F.pad(x, ((k - 1) * dilation, 0))
        return F.conv1d(x, w.permute(2, 1, 0), b, dilation=dilation)

    def half_snake(self, x, alpha):
        n = alpha.shape[0]
        a = alpha[None, :, None]
        first, rest = x[:, :n], x[:, n:]
        snake = first + torch.sin(a * first) ** 2 / a
        return torch.cat([snake, F.leaky_relu(rest, self.hp["leaky_slope"])], 1)

    def latent(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [N, T, 8] -> latent [N, 32, T]: per codebook, 4 FSQ digits
        (levels 8, 7, 6, 6), each mapped to [-1, 1]."""
        levels = torch.tensor(self.hp["fsq_levels"], device=codes.device)
        base = torch.tensor(self.hp["fsq_dim_base"], device=codes.device)
        half = levels // 2
        digits = torch.remainder(torch.div(codes.long()[..., None], base, rounding_mode="floor"),
                                 levels)
        vals = (digits - half).float() / half.float()                # [N, T, 8, 4]
        return vals.flatten(-2).transpose(1, 2)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [N, T, 8] -> audio [N, T * hop] float32 in [-1, 1]."""
        w, hp = self.w, self.hp
        with precision_flags(self.precision), torch.no_grad():
            x = self.conv(self.latent(codes), w["pre_conv_w"], w["pre_conv_b"])
            for i, stride in enumerate(hp["up_sample_rates"]):
                sp = f"stages.{i}."
                x = self.half_snake(x, w[sp + "act_alpha"])
                wt = w[sp + "convt_w"]
                out_ch = wt.shape[0] // 2
                T = x.shape[-1]
                xi = fp8_round(x) if self.precision == "fp8" else x
                x = F.conv_transpose1d(xi, wt[:, None, :], w[sp + "convt_b"], stride=stride,
                                       groups=out_ch)[..., :T * stride]
                branches = []
                for j in range(len(hp["resblock_kernel_sizes"])):
                    h = x
                    for d, dil in enumerate(hp["resblock_dilations"]):
                        bp = f"{sp}resblocks.{j}.{d}."
                        y = self.conv(self.half_snake(h, w[bp + "in_alpha"]), w[bp + "in_conv_w"],
                                      w[bp + "in_conv_b"], dil)
                        h = self.conv(self.half_snake(y, w[bp + "sk_alpha"]), w[bp + "sk_conv_w"],
                                      w[bp + "sk_conv_b"]) + h
                    branches.append(h)
                x = sum(branches) / len(branches)
            x = self.conv(self.half_snake(x, w["post_alpha"]), w["post_conv_w"], w["post_conv_b"])
            return torch.tanh(x)[:, 0]
