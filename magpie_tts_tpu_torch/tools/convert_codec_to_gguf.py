"""Convert a NeMo nano-codec checkpoint (.nemo tar) to GGUF
(tools/convert_codec_to_gguf.py, on the port's ``io.gguf`` writer: the same
arguments and byte-identical output, with no JAX installed).

Matches the reference converter behavior (scripts/convert_codec_to_gguf.py):
keeps only audio_decoder.* and vector_quantizer.* tensors, folds weight-norm
parametrizations (w = g * v / ||v||), and shortens names to fit ggml's 64-char
limit (audio_decoder. -> dec., .res_layers. -> .rl., ...).

Usage:
    python -m magpie_tts_tpu_torch.tools.convert_codec_to_gguf codec.nemo out.gguf [--f16]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import gguf
from .convert_nemo_to_gguf import load_nemo_state_dict

NAME_REPLACEMENTS = (
    ("audio_decoder.", "dec."),
    ("vector_quantizer.", "vq."),
    (".res_layers.", ".rl."),
    (".res_blocks.", ".rb."),
    (".up_sample_conv_layers.", ".up."),
    (".activations.", ".act."),
    (".input_activation.activation.snake_act.", ".in_act."),
    (".skip_activation.activation.snake_act.", ".sk_act."),
    (".input_conv.conv.", ".in_conv."),
    (".skip_conv.conv.", ".sk_conv."),
    (".post_activation.activation.snake_act.", ".post_act."),
    (".pre_conv.conv.", ".pre."),
    (".post_conv.conv.", ".post."),
    (".conv.", ".c."),
)

CODEC_KV = {
    "codec.sample_rate": 22050,
    "codec.num_codebooks": 8,
    "codec.codebook_size": 2016,
    "codec.hop_length": 1024,
    "codec.latent_dim": 32,
}


def shorten_name(name: str) -> str:
    for old, new in NAME_REPLACEMENTS:
        name = name.replace(old, new)
    return name


def fold_weight_norm(tensors: dict) -> dict:
    """Combine parametrizations.weight.original0/1 (g, v) into plain weights."""
    out = {}
    pending = {}
    for name, data in tensors.items():
        if ".parametrizations.weight.original0" in name:
            base = name.replace(".parametrizations.weight.original0", "")
            pending.setdefault(base, {})["g"] = data
        elif ".parametrizations.weight.original1" in name:
            base = name.replace(".parametrizations.weight.original1", "")
            pending.setdefault(base, {})["v"] = data
        else:
            out[name] = data
    for base, pair in pending.items():
        if "g" in pair and "v" in pair:
            g, v = pair["g"], pair["v"]
            norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=(1, 2),
                                  keepdims=True) + 1e-12)
            out[base + ".weight"] = (g * v / norm).astype(np.float32)
    return out


def convert(input_path: str, output_path: str, use_f16: bool = False) -> None:
    tensors, _ = load_nemo_state_dict(input_path)
    tensors = {k: v for k, v in tensors.items()
               if k.startswith(("audio_decoder.", "vector_quantizer."))}
    tensors = fold_weight_norm(tensors)

    writer = gguf.GGUFWriter()
    writer.add_metadata("general.architecture", "nano-codec")
    for key, value in CODEC_KV.items():
        writer.add_metadata(key, value)

    ttype = gguf.GGML_F16 if use_f16 else gguf.GGML_F32
    for name, data in sorted(tensors.items()):
        short = shorten_name(name)
        if len(short) > 64:
            print(f"warning: name still >64 chars: {short}", file=sys.stderr)
        writer.add_tensor(short, data.astype(np.float32), ttype)
    writer.write(output_path)
    print(f"wrote {output_path}: {len(tensors)} tensors", file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--f16", action="store_true")
    args = p.parse_args(argv)
    convert(args.input, args.output, args.f16)


if __name__ == "__main__":
    main()
