"""Command-line interface of the PyTorch/CUDA port, argv-compatible with the
JAX package's ``magpie-tts`` synth command: -m/-c/-t/-o/-s/--temp/--top-k/
--seed/--gelu/-q, plus --device {cuda,cpu}.

There is no device fallback: without a CUDA device the command fails unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

# Surfaces of the JAX CLI that this port does not have yet.
_NOT_PORTED_COMMANDS = ("serve", "warmup")
_NOT_PORTED_FLAGS = ("--serve-int8", "--serve-q8", "--stream", "--no-fused")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="magpie-tts-torch",
        description="Magpie TTS (PyTorch/CUDA port)")
    p.add_argument("-m", "--model", default="weights/magpie-357m-f32.gguf",
                   help="path to Magpie GGUF model")
    p.add_argument("-c", "--codec", default="weights/nano-codec-f32.gguf",
                   help="path to nano-codec GGUF model")
    p.add_argument("-t", "--text", default="Hello, world!", help="text to synthesize")
    p.add_argument("-o", "--output", default="output.wav", help="output WAV path")
    p.add_argument("-s", "--speaker", type=int, default=0, help="speaker id (0-4)")
    p.add_argument("--temp", type=float, default=0.7, help="sampling temperature")
    p.add_argument("--top-k", type=int, default=80, help="top-k for sampling")
    p.add_argument("--seed", type=int, default=0, help="sampling seed")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (no fallback: cuda needs a CUDA device)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="compute dtype (only float32 is ported)")
    p.add_argument("--gelu", choices=("erf", "tanh"), default=None,
                   help="GELU flavor for every FFN: 'erf' (default) or 'tanh'")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="only print the output filename")
    return p


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in _NOT_PORTED_COMMANDS:
        print(f"error: '{argv[0]}' is not ported to the PyTorch package yet "
              f"(use magpie_tts_tpu.cli)", file=sys.stderr)
        return 2
    unported = [a for a in argv if a.split("=")[0] in _NOT_PORTED_FLAGS]
    if unported:
        print(f"error: {', '.join(unported)} not ported to the PyTorch package yet",
              file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)

    import torch

    from .io.wav import write_wav
    from .pipeline import MagpiePipeline

    def log(msg: str):
        if not args.quiet:
            print(msg, file=sys.stderr)

    if args.dtype != "float32":
        print(f"error: --dtype {args.dtype} is not ported yet (float32 only)", file=sys.stderr)
        return 1
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device available (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1

    log(f"loading model {args.model} + codec {args.codec} (device={args.device})...")
    t0 = time.perf_counter()
    try:
        pipeline = MagpiePipeline.from_gguf(args.model, args.codec, device=args.device,
                                            gelu_flavor=args.gelu)
    except FileNotFoundError as e:
        print(f"error: model file not found: {e.filename or e}", file=sys.stderr)
        return 1
    except (ValueError, OSError) as e:
        print(f"error: failed to load model: {e}", file=sys.stderr)
        return 1
    log(f"loaded in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    codes = pipeline.synthesize_codes(args.text, speaker_id=args.speaker,
                                      temperature=args.temp, top_k=args.top_k,
                                      seed=args.seed)
    samples = pipeline.codec.decode(codes, pcm16=True)
    elapsed = time.perf_counter() - t0

    n_frames = codes.shape[0]
    seconds = len(samples) / pipeline.config.sample_rate
    fps = n_frames / elapsed if elapsed > 0 else 0.0
    log(f"synthesized {n_frames} frames / {seconds:.2f}s audio in {elapsed:.2f}s "
        f"({fps:.1f} fps, {seconds / elapsed if elapsed else 0.0:.1f}x real-time)")

    write_wav(args.output, samples, pipeline.config.sample_rate)
    print(args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
