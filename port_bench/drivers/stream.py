"""The streaming path: ``runtime.streaming.stream_sentence`` on a
``MagpieEngine`` and a ``CodecEngine``, as ``magpie-tts --stream`` runs it:
one client, sentences back to back, each prepared (``begin_stream``), then
decoded ``frames_per_chunk`` frames at a time (``decode_chunk``, kernel A a
frame), each chunk vocoded with ``codec_context_frames`` frames of context.

Window: sentences start until ``seconds`` have passed; the last one runs to
its end. A sentence's time to first audio runs from its token ids being
handed to ``stream_sentence`` to its first chunk's samples on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import port, traffic
from ..check import Served
from ..reference import sampling


class State:
    def __init__(self, engine, codec):
        self.engine, self.codec = engine, codec
        self.codes = []            # the codes of every decode_chunk call, in order
        self.end = None            # the codes [8] of the frame the sentence ended on


def _params(ctx, req):
    from magpie_tts_tpu_torch.runtime.streaming import StreamParams

    s = ctx.workload["stream"]
    return StreamParams(temperature=ctx.temperature, top_k=ctx.top_k, speaker_id=req.speaker,
                        frames_per_chunk=s["frames_per_chunk"], seed=req.seed,
                        codec_context_frames=s["codec_context_frames"])


def setup(ctx) -> State:
    """Engines, then one ``warmup_streaming`` per token bucket the cell's
    prompts reach."""
    from magpie_tts_tpu_torch.runtime.engine import CodecEngine, MagpieEngine, pick_bucket
    from magpie_tts_tpu_torch.runtime.streaming import warmup_streaming

    port.load_kernels(ctx.device)
    engine = MagpieEngine(ctx.magpie_weights, ctx.mcfg, device=ctx.device,
                          compute_dtype=ctx.dtype)
    codec = CodecEngine(ctx.codec_weights, ctx.ccfg, device=ctx.device, compute_dtype=ctx.dtype)
    lo, hi = ctx.workload["traffic"]["prompt_tokens"]
    buckets = sorted({pick_bucket(engine.token_buckets, n) for n in range(lo, hi + 1)})
    probe = traffic.Request(-1, (), 0, 0)
    warmup_streaming(engine, codec, _params(ctx, probe), token_buckets=buckets)
    st = State(engine, codec)
    chunk = engine.decode_chunk

    def kept(stream, *a, **k):
        out = chunk(stream, *a, **k)
        st.codes.append(out[0])
        s = stream["state"]
        if s.done and s.frame_idx < ctx.mcfg.max_dec_steps:   # the EOS frame: written, not counted
            st.end = np.array(s.codes[s.frame_idx], copy=True)
        return out
    engine.decode_chunk = kept
    return st


def instrument(ctx, st: State, tracer) -> None:
    tracer.wrap_method(st.engine, "begin_stream", "prepare")
    tracer.wrap_method(st.engine, "decode_chunk", "chunk")
    tracer.wrap_method(st.codec, "decode", "codec")


def window(ctx, st: State, seconds: float) -> dict:
    from magpie_tts_tpu_torch.runtime.streaming import stream_sentence

    source = traffic.order(traffic.pool(ctx.workload["traffic"], ctx.hp), ctx.seed)
    done = []
    with torch.no_grad():
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            req = next(source)
            st.codes.clear()
            st.end = None
            chunks = []
            t_start = time.perf_counter()
            t_first = None
            for chunk in stream_sentence(st.engine, st.codec, list(req.tokens), _params(ctx, req)):
                if t_first is None:
                    t_first = time.perf_counter()
                chunks.append(chunk.samples)
            t_done = time.perf_counter()
            codes = (np.concatenate(st.codes) if st.codes
                     else np.zeros((0, ctx.mcfg.num_codebooks), np.int32))
            done.append(dict(req=req, codes=codes, end=st.end, t_start=t_start,
                             t_first=t_first, t_done=t_done,
                             audio=np.concatenate(chunks) if chunks else np.zeros(0, np.float32)))
        t_end = time.perf_counter()
    frames = int(sum(d["codes"].shape[0] for d in done))
    return dict(
        t0=t0, t_end=t_end, items=done, frames_done=frames,
        ttfa_ms=[1e3 * (d["t_first"] - d["t_start"]) if d["t_first"] else float("inf")
                 for d in done],
        attempted=len(done), failed=sum(1 for d in done if d["t_first"] is None),
        counts={"sentences": len(done), "frames_generated": frames, "vocoded_frames": frames,
                "lengths": [int(d["codes"].shape[0]) for d in done]})


def served(ctx, win: dict) -> list:
    """Each sentence with its frame seeds, the frame it ended on included:
    chunk i samples with ``fold_in(prng_key(seed), i)``, split once a frame,
    ``frames_per_chunk`` frames a chunk; and the ending frame's codes."""
    k = ctx.workload["stream"]["frames_per_chunk"]
    out = []
    for d in win["items"]:
        n = d["codes"].shape[0]
        chunks = n // k + 1
        keys = sampling.request_keys([d["req"].seed] * chunks, list(range(chunks)))
        seeds = sampling.frame_seeds(keys, k).reshape(-1)[:n + 1]
        out.append(Served(d["req"].tokens, d["req"].speaker, d["codes"], seeds, d["audio"],
                          d["end"]))
    return out
