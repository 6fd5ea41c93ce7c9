"""Command-line interface of the PyTorch/CUDA port, argv-compatible with the
JAX package's ``magpie-tts``: the synth command (-m/-c/-t/-o/-s/--temp/
--top-k/--seed/--gelu/--no-fused/-q) and ``serve`` (-m/-c/--out-dir/--slots/
--segment-frames/--temp/--top-k/--dtype/--gelu/-q), each plus
--device {cuda,cpu}.

There is no device fallback: without a CUDA device a command fails unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

# Surfaces of the JAX CLI that this port does not have yet.
_NOT_PORTED_COMMANDS = ("warmup",)
_NOT_PORTED_FLAGS = ("--serve-int8", "--serve-q8", "--stream")


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
    p.add_argument("--no-fused", action="store_true",
                   help="disable the fused per-frame megakernel (LT sampling + "
                        "decoder step in one kernel); runs the separate "
                        "kernels instead. Equivalent env var: MAGPIE_NO_FUSED")
    p.add_argument("--gelu", choices=("erf", "tanh"), default=None,
                   help="GELU flavor for every FFN: 'erf' (default) or 'tanh'")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="only print the output filename")
    return p


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="magpie-tts-torch serve",
        description="Continuous-batching TTS server: JSONL requests on stdin "
                    "({\"id\", \"text\", optional \"speaker\"/\"seed\"} or plain "
                    "text lines), one WAV per request, JSONL results on stdout.")
    p.add_argument("-m", "--model", default="weights/magpie-357m-f32.gguf")
    p.add_argument("-c", "--codec", default="weights/nano-codec-f32.gguf")
    p.add_argument("--out-dir", default=".", help="directory for output WAVs")
    p.add_argument("--slots", type=int, default=8, help="concurrent decode slots")
    p.add_argument("--segment-frames", type=int, default=32,
                   help="frames decoded per scheduler segment")
    p.add_argument("--temp", type=float, default=0.7)
    p.add_argument("--top-k", type=int, default=80)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (no fallback: cuda needs a CUDA device; "
                        "serves on the first card, also where there are several)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="compute dtype (only float32 is ported; the JAX serve defaults "
                        "to bfloat16)")
    p.add_argument("--gelu", choices=("erf", "tanh"), default=None,
                   help="GELU flavor for every FFN (see `magpie-tts-torch --help`)")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def serve(argv) -> int:
    """Continuous-batching serving loop over stdin/stdout.

    stdin is drained on a reader thread, so requests are admitted while
    decoding runs: a request submitted after the batch started joins it at
    the next segment boundary. Malformed or failing requests get an
    ``{"error": ...}`` line instead of stopping the server. Finished requests
    are vocoded together (``CodecEngine.decode_batch``); each gets a WAV and
    one JSON line.
    """
    import json
    import os
    import queue
    import threading

    args = build_serve_parser().parse_args(argv)

    import torch

    from .io.codec_weights import load_codec_weights
    from .io.gguf import GGUFReader
    from .io.magpie_weights import load_magpie_weights
    from .io.wav import write_wav
    from .parallel.continuous import ContinuousBatchingEngine
    from .runtime.engine import CodecEngine
    from .text.tokenizer import MagpieTokenizer

    def log(msg):
        if not args.quiet:
            print(msg, file=sys.stderr)

    if args.dtype != "float32":
        print(f"error: --dtype {args.dtype} is not ported yet (float32 only)", file=sys.stderr)
        return 1
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device available (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    try:
        reader = GGUFReader(args.model)
        config, weights = load_magpie_weights(args.model, reader=reader)
        if args.gelu is not None:
            import dataclasses

            config = dataclasses.replace(config, gelu_flavor=args.gelu)
        tokenizer = MagpieTokenizer.from_gguf_metadata(reader.metadata)
        codec_config, codec_weights = load_codec_weights(args.codec)
    except FileNotFoundError as e:
        print(f"error: model file not found: {e.filename or e}", file=sys.stderr)
        return 1
    except (ValueError, OSError) as e:
        print(f"error: failed to load model: {e}", file=sys.stderr)
        return 1

    # One engine on one device, also on a host with several cards:
    # parallel.continuous.MultiChipContinuousServer runs one engine per card,
    # but its engines' per-frame Python loops share one interpreter lock, and
    # on four cards it served slower than one engine on one card.
    engine = ContinuousBatchingEngine(weights, config, n_slots=args.slots, device=args.device,
                                      segment_frames=args.segment_frames)
    engine.split_token_id = tokenizer.space_id
    log(f"serve: {args.slots} slots, segment={args.segment_frames} frames "
        f"(device={engine.device})")
    codec = CodecEngine(codec_weights, codec_config, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    names = {}

    # Reader thread: stdin never blocks the decode loop (None sentinel = EOF).
    lines: "queue.Queue[str | None]" = queue.Queue()
    stdin = sys.stdin
    threading.Thread(target=lambda: ([lines.put(ln) for ln in stdin], lines.put(None)),
                     daemon=True).start()

    def emit(obj):
        print(json.dumps(obj), flush=True)

    def admit(line: str) -> None:
        line = line.strip()
        if not line:
            return
        req = {"text": line}
        if line.startswith("{"):
            try:
                req = json.loads(line)
            except json.JSONDecodeError as e:
                emit({"error": f"malformed JSON request: {e}"})
                return
        rid_name = str(req.get("id", ""))
        try:
            tokens = tokenizer.encode(req["text"])
            rid = engine.submit(tokens, speaker_id=int(req.get("speaker", 0)),
                                seed=int(req.get("seed", 0)))
        except Exception as e:  # bad field types, empty text, ...
            emit({"id": rid_name, "error": f"{type(e).__name__}: {e}"})
            return
        names[rid] = rid_name or str(rid)

    n_done = 0
    total_frames = 0
    t0 = time.perf_counter()
    # The span marks the window of the aggregate-fps line for a profiler
    # (chip_profile.py reads the device's busy share over it).
    with torch.profiler.record_function("serve.loop"):
        eof = False
        while not eof or engine.pending:
            # Drain everything already queued; block only when idle.
            while True:
                try:
                    line = lines.get(block=not engine.pending and not eof)
                except queue.Empty:
                    break
                if line is None:
                    eof = True
                    break
                admit(line)
                if engine.pending and lines.empty():
                    break  # do not starve the decode loop
            if not engine.pending:
                continue
            finished = engine.step(temperature=args.temp, top_k=args.top_k)
            if not finished:
                continue
            try:
                audios = codec.decode_batch(list(finished.values()))
            except Exception as e:
                for rid in finished:
                    emit({"id": names.get(rid, str(rid)),
                          "error": f"codec decode failed: {type(e).__name__}: {e}"})
                continue
            for (rid, codes), audio in zip(finished.items(), audios):
                path = os.path.join(args.out_dir, f"{names.get(rid, rid)}.wav")
                write_wav(path, audio, config.sample_rate)
                total_frames += codes.shape[0]
                n_done += 1
                emit({"id": names.get(rid, str(rid)), "wav": path, "frames": int(codes.shape[0]),
                      "seconds": round(len(audio) / config.sample_rate, 3)})
        dt = time.perf_counter() - t0
    log(f"serve: {n_done} requests, {total_frames} frames in {dt:.2f}s "
        f"({total_frames / dt:.0f} aggregate fps)" if dt > 0 else "serve: done")
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "serve":
        return serve(argv[1:])
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
                                            gelu_flavor=args.gelu,
                                            use_fused=False if args.no_fused else None)
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
