"""The serving path: ``ContinuousBatchingEngine.submit`` / ``step`` and
``CodecEngine.decode_batch``, as ``magpie-tts serve`` runs them (cli.py's
serve loop, without its WAV writes), in one process.

The cell's traffic is a closed loop of ``traffic.clients`` callers, each
sending its next request when its last one's audio is back. Requests are
admitted at segment boundaries, vocoded in one batch per segment. A request
keeps its pool identity as the engine's request id, so its sampling key, and
with it its output, does not depend on the order the seed gives; a prompt
longer than the largest token bucket, which the engine would split into
children of further ids, is refused.

Window: requests are sent until ``seconds`` have passed; it ends with the
step that crosses it.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from .. import port, traffic
from ..check import Served
from ..reference import sampling


class State:
    def __init__(self, engine, codec):
        self.engine, self.codec = engine, codec
        self.ends = {}             # request id -> the codes [8] of the frame it ended on
        retire = engine._retire_finished

        def kept(codes_seg, counts_before):
            """The engine's retirement, keeping each EOS frame's codes (the
            engine leaves that frame out of a request's codes)."""
            for slot, rid in enumerate(engine._slot_req):
                new = int(engine._counts_host[slot] - counts_before[slot])
                if rid is not None and engine._done_host[slot] and new < codes_seg.shape[0]:
                    self.ends[rid] = codes_seg[new, slot, :].copy()
            return retire(codes_seg, counts_before)
        engine._retire_finished = kept


def _engine(ctx):
    from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine

    e = ctx.workload["engine"]
    return ContinuousBatchingEngine(
        ctx.magpie_weights, ctx.mcfg, n_slots=e["slots"], device=ctx.device,
        compute_dtype=ctx.dtype, token_buckets=tuple(e["token_buckets"]),
        segment_frames=e["segment_frames"])


def setup(ctx) -> State:
    """Engines, then every shape the cell's traffic uses: ``prepare_batch``
    at each token bucket the prompts reach and each power-of-two group up to
    the slots, one segment of the frame kernel at the slot count, the codec
    at each frame bucket."""
    from magpie_tts_tpu_torch.models import magpie as magpie_mod
    from magpie_tts_tpu_torch.runtime.engine import CodecEngine, pick_bucket

    port.load_kernels(ctx.device)
    codec = CodecEngine(ctx.codec_weights, ctx.ccfg, device=ctx.device, compute_dtype=ctx.dtype)
    engine = _engine(ctx)
    c, e = ctx.mcfg, ctx.workload["engine"]
    lo, hi = ctx.workload["traffic"]["prompt_tokens"]
    buckets = sorted({pick_bucket(e["token_buckets"], n) for n in (lo, hi)} |
                     {b for b in e["token_buckets"] if lo <= b <= hi})
    with torch.no_grad():
        for bucket in buckets:
            m = 1
            while m <= e["slots"]:
                tokens = torch.full((m, bucket), 2, dtype=torch.int64, device=engine.device)
                magpie_mod.prepare_batch(tokens, [bucket] * m, [0] * m, engine.prepare_weights, c)
                m *= 2
        warm = [traffic.Request(-1, tuple([c.text_bos_id] + [2] * (b - 2) + [c.text_eos_id]),
                                0, 0) for b in buckets]
        for i in range(e["slots"]):
            req = warm[i % len(warm)]
            engine.submit(list(req.tokens), speaker_id=0, seed=i)
        engine.step(temperature=ctx.temperature, top_k=ctx.top_k)
        for frames in codec.frame_buckets:
            codec.decode_batch([np.zeros((frames, c.num_codebooks), np.int32)])
    # A fresh engine for the window: the warm one's slots are busy.
    del engine
    return State(_engine(ctx), codec)


def instrument(ctx, st: State, tracer) -> None:
    tracer.wrap_method(st.engine, "_admit_pending", "admit")
    tracer.wrap_method(st.engine, "_segment", "segment")
    tracer.wrap_method(st.engine, "_retire_finished", "retire")
    tracer.wrap_method(st.codec, "decode_batch", "codec")


def _submit(engine, req, inflight) -> None:
    engine._next_id = req.index
    rid = engine.submit(list(req.tokens), speaker_id=req.speaker, seed=req.seed)
    inflight[rid] = req


def window(ctx, st: State, seconds: float) -> dict:
    tr = ctx.workload["traffic"]
    if tr["loop"] != "closed":
        raise ValueError(f"the serve driver runs closed loops, not {tr['loop']!r}")
    if tr["prompt_tokens"][1] > max(ctx.workload["engine"]["token_buckets"]):
        raise ValueError("prompts longer than the largest token bucket would be split "
                         "into children whose ids collide with the pool's")
    engine, codec = st.engine, st.codec
    source = traffic.order(traffic.pool(tr, ctx.hp), ctx.seed)
    deferred = deque()
    inflight = {}
    done = []

    def next_request():
        for _ in range(len(deferred)):
            req = deferred.popleft()
            if req.index not in inflight:
                return req
            deferred.append(req)
        while True:
            req = next(source)
            if req.index not in inflight:
                return req
            deferred.append(req)

    sent = 0
    segments = 0
    with torch.no_grad():
        t0 = time.perf_counter()
        deadline = t0 + seconds
        for _ in range(tr["clients"]):
            _submit(engine, next_request(), inflight)
            sent += 1
        while True:
            finished = engine.step(temperature=ctx.temperature, top_k=ctx.top_k)
            segments += 1
            if finished:
                audios = codec.decode_batch(list(finished.values()))
                t_done = time.perf_counter()
                for (rid, codes), audio in zip(finished.items(), audios):
                    req = inflight.pop(rid)
                    done.append(dict(req=req, rid=rid, codes=codes, audio=audio,
                                     end=st.ends.pop(rid, None)))
                    if t_done < deadline:
                        _submit(engine, next_request(), inflight)
                        sent += 1
            if time.perf_counter() >= deadline:
                break
        t_end = time.perf_counter()
    frames = int(sum(d["codes"].shape[0] for d in done))
    return dict(
        t0=t0, t_end=t_end, items=done, frames_done=frames,
        attempted=len(done), failed=0,
        counts={"requests": len(done), "sent": sent, "segments": segments,
                "engine_frames": segments * engine.segment_frames,
                "vocoded_frames": frames, "admitted": sent - len(engine._queue),
                "lengths": [int(d["codes"].shape[0]) for d in done]})


def served(ctx, win: dict) -> list:
    """Each finished request with the frame seeds the engine sampled it with
    (``fold_in(prng_key(seed), request id)``, split once a frame), the frame
    it ended on included, and that frame's codes."""
    items = win["items"]
    if not items:
        return []
    keys = sampling.request_keys([d["req"].seed for d in items], [d["rid"] for d in items])
    seeds = sampling.frame_seeds(keys, max(d["codes"].shape[0] for d in items) + 1)
    return [Served(d["req"].tokens, d["req"].speaker, d["codes"],
                   seeds[i, :d["codes"].shape[0] + 1], d["audio"], d["end"])
            for i, d in enumerate(items)]
