"""Dump per-layer golden tensors of a GGUF checkpoint (tools/dump_golden.py):
the same dumps, names and ``.bin`` layout as the JAX tool, so either tree
diffs against the other, or against the reference's, with
``tools.verify_golden``.

Usage:
    python -m magpie_tts_tpu_torch.tools.dump_golden -m magpie.gguf \\
        [-c codec.gguf] -t "Hello, world!" -o test_data/ [--device cuda|cpu]

Dumps: tokens, per-layer encoder hiddens, XA K/V, per-layer full-sequence
decoder hiddens over [context; BOS; greedy frames], the final projection,
per-codebook LT logits and greedy codes from the BOS-step hidden, the greedy
frames of the cached engine (``MagpieEngine.begin_stream`` /
``decode_chunk`` at temperature 0: kernel A on a card), and with ``-c`` the
FSQ latent, each codec stage and the audio. The checkpoint is read through
the native reader (``io.native.open_gguf``); the traces are plain PyTorch on
``--device``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


def trace_dumps(tokens, weights, config, speaker_id: int, frames: np.ndarray,
                codec=None) -> Dict[str, np.ndarray]:
    """Every traced golden of one utterance: tokens, encoder, decoder over
    [context; BOS; ``frames``], the LT pass from the BOS-step hidden and,
    with ``codec`` = (CodecWeights, CodecConfig) and frames, the codec."""
    from ..io import trace_forward as tf

    dumps = {"tokens": np.asarray(tokens, np.float32)}
    dumps.update(tf.trace_encoder(torch.as_tensor(np.asarray(tokens, np.int64)), weights,
                                  config))
    dec = tf.trace_decoder(torch.from_numpy(dumps["encoder_output"]), weights, config,
                           speaker_id=speaker_id, frames=np.asarray(frames, np.int32))
    dumps.update(dec)
    hidden = torch.from_numpy(dec["decoder_output"][config.context_frames])  # BOS step
    dumps.update(tf.trace_local_transformer(hidden.to(weights.text_emb.dtype), weights, config))
    if codec is not None and len(frames):
        codec_weights, codec_config = codec
        dumps.update(tf.trace_codec(np.asarray(frames, np.int32), codec_weights, codec_config))
    return dumps


def greedy_codes(weights, config, tokens, speaker_id: int, n_frames: int, device,
                 q8_stream=None) -> np.ndarray:
    """Greedy frames [n, 8] of the cached engine on ``device`` in the
    weights' dtype (stops at EOS)."""
    from ..runtime.engine import MagpieEngine

    engine = MagpieEngine(weights, config, device=device, compute_dtype=weights.text_emb.dtype,
                          token_buckets=(len(tokens),), q8_stream=q8_stream)
    stream = engine.begin_stream(tokens, speaker_id=speaker_id)
    codes, _done = engine.decode_chunk(stream, n_frames=n_frames, temperature=0.0)
    return np.asarray(codes, np.int64)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-c", "--codec", default=None,
                   help="codec GGUF; enables per-stage codec dumps")
    p.add_argument("-t", "--text", default="Hello, world!")
    p.add_argument("-o", "--output-dir", default="test_data")
    p.add_argument("-s", "--speaker", type=int, default=0)
    p.add_argument("--frames", type=int, default=4,
                   help="greedy frames to generate for decoder/codec goldens")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the engine and the traces run (no fallback)")
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)

    from ..io.codec_weights import load_codec_weights
    from ..io.golden import write_golden
    from ..io.magpie_weights import load_magpie_weights
    from ..io.native import open_gguf
    from ..runtime.engine import resolve_device
    from ..text.tokenizer import MagpieTokenizer

    device = resolve_device(args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    reader = open_gguf(args.model)
    config, weights = load_magpie_weights(args.model, reader=reader)
    tokenizer = MagpieTokenizer.from_gguf_metadata(reader.metadata)
    tokens = tokenizer.encode(args.text)
    print(f"tokens ({len(tokens)}): {tokens}", file=sys.stderr)

    # Greedy frames from the cached engine, also the decoder / codec trace input.
    codes = greedy_codes(weights, config, tokens, args.speaker, args.frames, device)
    codec = None
    if args.codec:
        codec_config, codec_weights = load_codec_weights(args.codec)
        codec = (codec_weights.to(device=device), codec_config)
    dumps = trace_dumps(tokens, weights.to(device=device), config, args.speaker, codes, codec)
    dumps["greedy_codes"] = codes.astype(np.float32)

    for name, arr in dumps.items():
        write_golden(str(out / f"{name}.bin"), arr)
    print(f"dumped {len(dumps)} goldens to {out}/ "
          f"(first-frame codes: {codes[0].tolist() if len(codes) else []})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
