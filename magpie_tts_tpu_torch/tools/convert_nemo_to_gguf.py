"""Convert a NeMo Magpie TTS checkpoint (.nemo tar) to GGUF
(tools/convert_nemo_to_gguf.py, on the port's ``io.gguf`` writer: the same
arguments and byte-identical output, with no JAX installed).

Produces files readable by both this framework and the reference C++ engine:
same tensor names, metadata keys, quantization gating, and Q8_0/Q4_0 block
layout as the reference converter (scripts/convert_magpie_to_gguf.py behavior).

Usage:
    python -m magpie_tts_tpu_torch.tools.convert_nemo_to_gguf model.nemo out.gguf \
        [-q q8_0|q4_0|f16]
        [--vocab tokenizer_data/vocab.txt --dict tokenizer_data/dict.txt]
"""

from __future__ import annotations

import argparse
import io
import re
import sys
import tarfile
from pathlib import Path

import numpy as np

from ..io import gguf

# Tensors not needed for inference (codec/speaker-encoder live in separate
# checkpoints; masks and metadata scalars are recomputed).
SKIP_PATTERNS = (
    "_codec_model", "speaker_encoder", "_speaker_encoder", "causal_mask",
    "_baked_embedding_D", "_baked_embedding_T", "baked_context_embedding_len",
)

# Only 2-D+ weight matrices on the attention/FFN/projection paths quantize;
# norms, biases and embeddings stay f32.
QUANT_PATTERNS = (
    r"\.layers\.\d+\.self_attention\.(qkv_net|o_net)\.weight$",
    r"\.layers\.\d+\.cross_attention\.(q_net|kv_net|o_net)\.weight$",
    r"\.layers\.\d+\.pos_ff\.(proj|o_net)\.conv\.weight$",
    r"^final_proj\.weight$",
    r"^local_transformer_out_projections\.\d+\.weight$",
    r"^local_transformer_in_projection\.weight$",
)

HPARAM_KV = {
    "magpie.sample_rate": 22050,
    "magpie.num_codebooks": 8,
    "magpie.codebook_size": 2016,
    "magpie.vocab_size_per_codebook": 2024,
    "magpie.text_vocab_size": 2380,
    "magpie.d_model": 768,
    "magpie.d_ffn": 3072,
    "magpie.encoder_layers": 6,
    "magpie.decoder_layers": 12,
    "magpie.encoder_heads": 12,
    "magpie.decoder_sa_heads": 12,
    "magpie.decoder_xa_heads": 1,
    "magpie.local_transformer_dim": 256,
    "magpie.local_transformer_layers": 1,
    "magpie.num_baked_speakers": 5,
    "magpie.baked_context_frames": 110,
    "magpie.text_bos_id": 2378,
    "magpie.text_eos_id": 2379,
    "magpie.audio_bos_id": 2016,
    "magpie.audio_eos_id": 2017,
    "magpie.context_audio_bos_id": 2018,
    "magpie.context_audio_eos_id": 2019,
    "magpie.mask_token_id": 2020,
}

QUANT_TYPES = {
    "q8_0": gguf.GGML_Q8_0, "q8": gguf.GGML_Q8_0,
    "q4_0": gguf.GGML_Q4_0, "q4": gguf.GGML_Q4_0,
    "f16": gguf.GGML_F16, "fp16": gguf.GGML_F16,
}


def load_nemo_state_dict(path: str):
    """Extract (state_dict of numpy arrays, config dict) from a .nemo tar."""
    import torch

    with tarfile.open(path) as tar:
        names = tar.getnames()

        def find(suffix):
            for n in names:
                if n.endswith(suffix):
                    return n
            return None

        config = {}
        cfg_name = find("model_config.yaml")
        if cfg_name:
            try:
                import yaml

                config = yaml.safe_load(tar.extractfile(cfg_name))
            except Exception:
                config = {}
        ckpt_name = find("model_weights.ckpt")
        if ckpt_name is None:
            raise ValueError(f"{path}: no model_weights.ckpt in archive")
        payload = tar.extractfile(ckpt_name).read()
        state = torch.load(io.BytesIO(payload), weights_only=True,
                           map_location="cpu")
        return {k: v.numpy() for k, v in state.items()}, config


def should_quantize(name: str, shape, quant_type) -> bool:
    if quant_type is None:
        return False
    n_elements = int(np.prod(shape))
    if n_elements < 256 or len(shape) < 2:
        return False
    if quant_type in (gguf.GGML_Q8_0, gguf.GGML_Q4_0) and shape[-1] < 32:
        return False
    return any(re.search(p, name) for p in QUANT_PATTERNS)


def convert(input_path: str, output_path: str, quant: str = None,
            vocab_path: str = None, dict_path: str = None) -> None:
    tensors, _config = load_nemo_state_dict(input_path)
    quant_type = QUANT_TYPES.get(quant.lower()) if quant else None

    writer = gguf.GGUFWriter()
    writer.add_metadata("general.architecture", "magpie")
    writer.add_metadata("general.name", "magpie-tts-multilingual-357m")
    for key, value in HPARAM_KV.items():
        writer.add_metadata(key, value)

    if vocab_path and Path(vocab_path).exists():
        vocab = Path(vocab_path).read_text(encoding="utf-8").rstrip("\n").split("\n")
        writer.add_metadata("magpie.tokenizer.vocab", "\n".join(vocab))
        writer.add_metadata("magpie.tokenizer.vocab_size", len(vocab))
    if dict_path and Path(dict_path).exists():
        content = Path(dict_path).read_text(encoding="utf-8")
        writer.add_metadata("magpie.tokenizer.dict", content)
        writer.add_metadata("magpie.tokenizer.dict_size", content.count("\n"))

    n_quant = n_f32 = 0
    for name, data in sorted(tensors.items()):
        if any(p in name for p in SKIP_PATTERNS):
            print(f"skip {name} {data.shape}", file=sys.stderr)
            continue
        if should_quantize(name, data.shape, quant_type):
            writer.add_tensor(name, data, quant_type)
            n_quant += 1
        else:
            writer.add_tensor(name, data.astype(np.float32), gguf.GGML_F32)
            n_f32 += 1
    writer.write(output_path)
    print(f"wrote {output_path}: {n_f32} f32 + {n_quant} quantized tensors",
          file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-q", "--quantize", choices=sorted(QUANT_TYPES))
    p.add_argument("--vocab", default="tokenizer_data/vocab.txt")
    p.add_argument("--dict", dest="dict_path", default="tokenizer_data/dict.txt")
    args = p.parse_args(argv)
    convert(args.input, args.output, args.quantize, args.vocab, args.dict_path)


if __name__ == "__main__":
    main()
