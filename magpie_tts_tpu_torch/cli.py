"""Command-line interface of the PyTorch/CUDA port, argv-compatible with the
JAX package's ``magpie-tts``: the synth command (-m/-c/-t/-o/-s/--temp/
--top-k/--seed/--stream/--dtype/--serve-int8/--serve-q8/--gelu/--no-fused/
-q), ``serve`` (-m/-c/--out-dir/--slots/--segment-frames/--temp/--top-k/
--dtype/--gelu/-q) and ``warmup`` (-m/-c/--dtype/--buckets/--surfaces/
--serve-slots/--segment-frames/--top-k/--gelu/--serve-int8/--serve-q8/-q),
each plus --device {cuda,cpu}.

There is no device fallback: without a CUDA device a command fails unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

WARMUP_SURFACES = ("offline", "fused", "stream", "serve")


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
    p.add_argument("--stream", action="store_true",
                   help="stream sentence by sentence, 4 frames a chunk (logs the time "
                        "to first audio)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (no fallback: cuda needs a CUDA device)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="on-device compute dtype")
    quant = p.add_mutually_exclusive_group()
    quant.add_argument("--serve-int8", action="store_true",
                       help="stream decoder weights as per-column int8 (half "
                            "the per-frame HBM traffic; ~Q8 quantization "
                            "error)")
    quant.add_argument("--serve-q8", action="store_true",
                       help="stream the checkpoint's OWN Q8_0 blocks (requires "
                            "a Q8_0 GGUF): zero requantization error at ~53%% "
                            "of the bf16 weight traffic (see docs/PARITY.md "
                            "for the numerics contract)")
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
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="bfloat16",
                   help="on-device compute dtype (bfloat16, as the JAX serve)")
    p.add_argument("--gelu", choices=("erf", "tanh"), default=None,
                   help="GELU flavor for every FFN (see `magpie-tts-torch --help`)")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def build_warmup_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="magpie-tts-torch warmup",
        description="Build the CUDA kernels and run each chosen serving surface once, so "
                    "that no request pays the nvcc build or a first run. The port has no "
                    "compilation cache: the kernel library under build/ (printed on "
                    "stdout) is what a later process reuses.")
    p.add_argument("-m", "--model", default="weights/magpie-357m-f32.gguf")
    p.add_argument("-c", "--codec", default="weights/nano-codec-f32.gguf")
    p.add_argument("--cache-dir", default=None,
                   help="not supported: the JAX compilation cache has no counterpart here")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (no fallback: cuda needs a CUDA device)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    p.add_argument("--buckets", default=None,
                   help="comma-separated token buckets (default: the engine's)")
    p.add_argument("--surfaces", default="offline",
                   help="comma-separated subset of offline,fused,stream,serve, or 'all'. "
                        "offline = the synth path (+ the codec's frame buckets); fused = "
                        "synthesize_audio_fused (codes + vocode + PCM16); stream = the "
                        "streaming chunks; serve = the continuous-batching engine")
    p.add_argument("--serve-slots", type=int, default=8,
                   help="slot count for the serve surface")
    p.add_argument("--segment-frames", type=int, default=32)
    p.add_argument("--top-k", type=int, default=80)
    p.add_argument("--gelu", choices=("erf", "tanh"), default=None)
    quant = p.add_mutually_exclusive_group()
    quant.add_argument("--serve-int8", action="store_true")
    quant.add_argument("--serve-q8", action="store_true")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def warmup(argv) -> int:
    """Build the kernels and run every requested surface once."""
    args = build_warmup_parser().parse_args(argv)
    if args.cache_dir is not None:
        print("error: --cache-dir names a JAX compilation cache, which the PyTorch port does "
              "not have (its kernels are built once under build/magpie_torch_kernels/)",
              file=sys.stderr)
        return 2
    surfaces = (WARMUP_SURFACES if args.surfaces.strip() == "all"
                else tuple(s.strip() for s in args.surfaces.split(",") if s.strip()))
    unknown = set(surfaces) - set(WARMUP_SURFACES)
    if unknown:
        print(f"error: unknown surface(s): {', '.join(sorted(unknown))}", file=sys.stderr)
        return 1

    import torch

    from .ops.kernels import build
    from .pipeline import MagpiePipeline

    def log(msg):
        if not args.quiet:
            print(msg, file=sys.stderr)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device available (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    dtype = getattr(torch, args.dtype)
    buckets = tuple(int(b) for b in args.buckets.split(",")) if args.buckets else None
    t0 = time.perf_counter()
    try:
        pipeline = MagpiePipeline.from_gguf(args.model, args.codec, device=args.device,
                                            compute_dtype=dtype, gelu_flavor=args.gelu,
                                            serve_int8=args.serve_int8,
                                            serve_q8=args.serve_q8)
    except FileNotFoundError as e:
        print(f"error: model file not found: {e.filename or e}", file=sys.stderr)
        return 1
    except (ValueError, OSError) as e:
        print(f"error: failed to load model: {e}", file=sys.stderr)
        return 1
    log(f"warmup: loaded in {time.perf_counter() - t0:.1f}s (device={args.device}, "
        f"dtype={args.dtype})")
    if args.device == "cuda":
        t = time.perf_counter()
        build.load_library()
        log(f"warmup: kernels  {time.perf_counter() - t:7.1f}s ({build.library_path()})")
    if pipeline.codec is None and {"fused", "stream"} & set(surfaces):
        print("error: the fused and stream surfaces need the codec (-c)", file=sys.stderr)
        return 1

    config = pipeline.config
    dummy = [config.text_bos_id, 2, config.text_eos_id]

    def stage(name, fn):
        t = time.perf_counter()
        fn()
        log(f"warmup: {name:8s} {time.perf_counter() - t:7.1f}s")

    if "offline" in surfaces:
        stage("offline", lambda: pipeline.warmup(token_buckets=buckets, top_k=args.top_k))
        if pipeline.codec is not None:
            stage("codec", pipeline.codec.warmup)
    if "fused" in surfaces:
        from .runtime.engine import synthesize_audio_fused

        def warm_fused():
            for bucket in (buckets or pipeline.engine.token_buckets):
                toks = dummy + [2] * (bucket - len(dummy))
                synthesize_audio_fused(pipeline.engine, pipeline.codec, toks[:bucket],
                                       temperature=0.0, top_k=args.top_k)
        stage("fused", warm_fused)
    if "stream" in surfaces:
        stage("stream", lambda: pipeline.warmup(streaming_path=True, token_buckets=buckets))
    if "serve" in surfaces:
        from .parallel.continuous import ContinuousBatchingEngine

        def warm_serve():
            # One engine on one card, as serve runs it.
            eng = ContinuousBatchingEngine(pipeline.engine.weights, config,
                                           n_slots=args.serve_slots, device=args.device,
                                           compute_dtype=dtype,
                                           segment_frames=args.segment_frames)
            eng.submit(dummy)
            while eng.pending:
                eng.step(temperature=0.0, top_k=args.top_k)
        stage("serve", warm_serve)

    log(f"warmup: total {time.perf_counter() - t0:.1f}s")
    print(build.library_path())
    return 0


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
    from .io.magpie_weights import load_magpie_weights
    from .io.native import open_gguf
    from .io.wav import write_wav
    from .parallel.continuous import ContinuousBatchingEngine
    from .runtime.engine import CodecEngine
    from .text.tokenizer import MagpieTokenizer

    def log(msg):
        if not args.quiet:
            print(msg, file=sys.stderr)

    dtype = getattr(torch, args.dtype)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device available (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    try:
        reader = open_gguf(args.model)
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
                                      compute_dtype=dtype, segment_frames=args.segment_frames)
    engine.split_token_id = tokenizer.space_id
    log(f"serve: {args.slots} slots, segment={args.segment_frames} frames "
        f"(device={engine.device}, dtype={args.dtype})")
    codec = CodecEngine(codec_weights, codec_config, device=args.device, compute_dtype=dtype)
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
    if argv and argv[0] == "warmup":
        return warmup(argv[1:])
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from .io.wav import write_wav
    from .pipeline import MagpiePipeline
    from .runtime.streaming import StreamParams

    def log(msg: str):
        if not args.quiet:
            print(msg, file=sys.stderr)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device available (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1

    log(f"loading model {args.model} + codec {args.codec} (device={args.device}, "
        f"dtype={args.dtype})...")
    t0 = time.perf_counter()
    try:
        pipeline = MagpiePipeline.from_gguf(args.model, args.codec, device=args.device,
                                            compute_dtype=getattr(torch, args.dtype),
                                            gelu_flavor=args.gelu,
                                            use_fused=False if args.no_fused else None,
                                            serve_int8=args.serve_int8,
                                            serve_q8=args.serve_q8)
    except FileNotFoundError as e:
        print(f"error: model file not found: {e.filename or e}", file=sys.stderr)
        return 1
    except (ValueError, OSError) as e:
        print(f"error: failed to load model: {e}", file=sys.stderr)
        return 1
    log(f"loaded in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    if args.stream:
        chunks = []
        params = StreamParams(temperature=args.temp, top_k=args.top_k,
                              speaker_id=args.speaker, seed=args.seed)
        for chunk in pipeline.stream(args.text, params):
            if not chunks:
                log(f"time to first audio: {(time.perf_counter() - t0) * 1000:.1f} ms")
            chunks.append(chunk.samples)
        samples = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    else:
        codes = pipeline.synthesize_codes(args.text, speaker_id=args.speaker,
                                          temperature=args.temp, top_k=args.top_k,
                                          seed=args.seed)
        samples = pipeline.codec.decode(codes, pcm16=True)
    elapsed = time.perf_counter() - t0

    n_frames = len(samples) // pipeline.codec.config.hop_length
    seconds = len(samples) / pipeline.config.sample_rate
    fps = n_frames / elapsed if elapsed > 0 else 0.0
    log(f"synthesized {n_frames} frames / {seconds:.2f}s audio in {elapsed:.2f}s "
        f"({fps:.1f} fps, {seconds / elapsed if elapsed else 0.0:.1f}x real-time)")

    write_wav(args.output, samples, pipeline.config.sample_rate)
    print(args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
