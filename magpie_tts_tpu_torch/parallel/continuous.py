"""Continuous batching (magpie_tts_tpu/parallel/continuous.py): requests join
and leave a RUNNING batch.

The decode loop runs in segments of ``segment_frames`` frames; between
segments the host retires finished slots and admits queued requests, each
token bucket's in power-of-two groups with one ``prepare_batch`` a group (on a
card one CUDA graph replay a group, captured at a (bucket, size)'s first use). The
ring cache keeps the JAX engine's design: every slot writes its new K/V row at
the same physical row ``ring_p + j`` (one shared ``write_row`` for the batched
frame kernel); what differs per slot is its logical position (for the
position embedding) and its validity mask over cache rows. An admitted
request's context + BOS rows are rolled into place ending at ``ring_p - 1``.
A slot lives at most ``max_seq - (context_frames + 2)`` steps.

Every frame is one ``frame_step_batched`` call plus a few tensor ops on the
device (the split path, ``use_fused=False`` or ``MAGPIE_NO_FUSED``: the
batched LT sampler, the bookkeeping, then the batched decoder step); the host
reads the device once per segment (frame counts, done flags, codes).
Sampling keys live on the host: a slot's key is
``fold_in(PRNGKey(seed), request_id)`` at admission and splits once per frame,
as in the JAX engine, so the per-frame seeds of a whole segment are derived
and uploaded at once.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import MagpieConfig
from ..io.magpie_weights import MagpieWeights, materialize_weights
from ..models import magpie as magpie_mod
from ..ops import sampling
from ..ops.kernels.decoder_step_batched import decode_step_batched
from ..ops.kernels.frame_step_batched import frame_step_batched
from ..ops.kernels.lt_sampler_batched import sample_frame_codes_batched
from ..runtime import telemetry
from ..runtime.engine import check_dtype, pick_bucket, resolve_device, split_to_buckets


@dataclasses.dataclass
class _Request:
    req_id: int
    token_ids: List[int]
    speaker_id: int
    seed: int
    submit_ns: int   # perf_counter_ns of its submit, where its queue wait starts


class ContinuousBatchingEngine:
    """Slot-based serving engine on one device: submit() requests, pump
    step(), collect codes. ``use_fused`` (None: fused unless MAGPIE_NO_FUSED)
    picks the fused frame kernel or the split sampler + decoder step, at any
    slot count (the JAX engine's ``slots % 8`` switch is Mosaic's)."""

    def __init__(self, weights: MagpieWeights, config: MagpieConfig, n_slots: int = 8,
                 device="cuda", compute_dtype=torch.float32,
                 token_buckets: Sequence[int] = (32, 64, 128), segment_frames: int = 32,
                 use_fused: Optional[bool] = None):
        check_dtype(compute_dtype)
        self.config = config
        self.use_fused = use_fused
        self.n_slots = n_slots
        self.segment_frames = segment_frames
        self.token_buckets = tuple(token_buckets)
        self.device = resolve_device(device)
        # Q8_0 blocks (--serve-q8 loads) dequantize once here: this engine
        # serves dense weights (the per-frame stream is a MagpieEngine surface).
        self.weights = materialize_weights(weights.to(device=self.device, dtype=compute_dtype))
        # What admission multiplies with: bf16 products on float32 copies;
        # on a card its groups replay as CUDA graphs, one a (bucket, size).
        self.prepare_weights = magpie_mod.float32_products(self.weights)
        self._prepare = magpie_mod.PrepareGraphs(self.prepare_weights, config)

        B, L = n_slots, config.dec_layers
        S, D = config.max_seq, config.d_model
        E = max(self.token_buckets)
        dev = self.device
        # Device-resident slot state.
        self.k_cache = torch.zeros(B, L, S, D, dtype=compute_dtype, device=dev)
        self.v_cache = torch.zeros_like(self.k_cache)
        self.xa_k = torch.zeros(B, L, E, config.d_xa, dtype=compute_dtype, device=dev)
        self.xa_v = torch.zeros_like(self.xa_k)
        self.hidden = torch.zeros(B, D, dtype=compute_dtype, device=dev)
        self.valid = torch.zeros(B, S, dtype=torch.bool, device=dev)
        self.logical_pos = torch.zeros(B, dtype=torch.int32, device=dev)
        self.frame_count = torch.zeros(B, dtype=torch.int32, device=dev)
        self.enc_lengths = torch.ones(B, dtype=torch.int32, device=dev)
        self.ring_p = config.context_frames + 1   # next shared write row
        # Rows [0, _rows_hi) may hold a valid row: the attention bound.
        self._rows_hi = self.ring_p

        # Host-side bookkeeping.
        self.keys = np.zeros((B, 2), np.uint32)   # per-slot sampling keys
        self.active = np.zeros(B, bool)
        self._done_host = np.zeros(B, bool)
        self._counts_host = np.zeros(B, np.int64)
        self._queue: deque[_Request] = deque()
        self._slot_req: List[Optional[int]] = [None] * n_slots
        self._partial: Dict[int, List[np.ndarray]] = {}
        self._finished: Dict[int, np.ndarray] = {}
        self._next_id = 0
        # Over-long requests split into child requests (word-boundary
        # chunks); the parent id is reported once every child finished.
        self._groups: Dict[int, List[int]] = {}
        self._group_parent: Dict[int, int] = {}
        # Inter-word space token for chunk splitting (serve passes the
        # tokenizer's id).
        self.split_token_id = 93

    # ---- admission, segment, retirement -------------------------------------

    def _admit_group(self, bucket: int, chunk: List[tuple]) -> None:
        """Prefill the M requests of ``chunk`` [(slot, request)] in one
        ``prepare_batch`` (on a card the replay of its graph for (bucket, M),
        ``PrepareGraphs``) and place them with indexed writes: each slot's
        context + BOS rows end at ring row ``ring_p - 1`` (wrapping past row
        0), its XA K/V fill rows [0, bucket) of a zeroed slot. The writes
        consume the graph's outputs on the stream before any later replay."""
        c, dev = self.config, self.device
        S, n_rows = c.max_seq, c.context_frames + 1
        with telemetry.span("engine.admit.group", bucket=bucket, requests=len(chunk)) as sp:
            if sp.on:
                sp.set(request_ids=[req.req_id for _, req in chunk],
                       queue_wait_ms=[(sp.start_ns - req.submit_ns) / 1e6 for _, req in chunk])
            tokens = np.zeros((len(chunk), bucket), np.int64)
            for i, (_, req) in enumerate(chunk):
                tokens[i, :len(req.token_ids)] = req.token_ids
            lens = [len(req.token_ids) for _, req in chunk]
            with telemetry.span("engine.admit.prepare") as pp:
                (xa_k, xa_v, k_rows, v_rows, hidden), mode = self._prepare(
                    tokens, lens, [req.speaker_id for _, req in chunk])
                pp.set(graph=mode)
            with telemetry.span("engine.admit.place"):
                start = self.ring_p - n_rows
                rows = (torch.arange(n_rows, device=dev) + start) % S
                # A pageable upload synchronizes the stream: the host waits
                # here for the device work enqueued before it.
                with telemetry.span("engine.admit.upload"):
                    slots = torch.tensor([slot for slot, _ in chunk], dtype=torch.int64).to(dev)
                for cache, new in ((self.k_cache, k_rows), (self.v_cache, v_rows)):
                    cache.index_fill_(0, slots, 0)
                    cache[slots[:, None], :, rows] = new.transpose(1, 2)   # [M, n_rows, L, D]
                for xa, new in ((self.xa_k, xa_k), (self.xa_v, xa_v)):
                    xa.index_fill_(0, slots, 0)
                    xa[slots, :, :bucket] = new
                vmask = torch.zeros(S, dtype=torch.bool, device=dev)
                vmask[rows] = True
                self.hidden[slots] = hidden
                self.valid[slots] = vmask
                with telemetry.span("engine.admit.upload"):
                    enc_lengths = torch.tensor(lens, dtype=torch.int32).to(dev)
                self.enc_lengths[slots] = enc_lengths
                self.logical_pos[slots] = n_rows
                self.frame_count[slots] = 0
                self._rows_hi = S if start < 0 else max(self._rows_hi, self.ring_p)
                for slot, req in chunk:
                    self.keys[slot] = sampling.fold_in(sampling.prng_key(req.seed), req.req_id)

    def _admit_pending(self) -> None:
        """Pop queued requests into free slots (lowest slot first), grouped by
        token bucket in queue order, as the JAX engine admits them: each
        bucket's requests in power-of-two chunks (the largest ``m`` <= the
        requests left and <= ``n_slots``), one ``prepare_batch`` a chunk."""
        with telemetry.span("engine.admit") as sp:
            free = [s for s in range(self.n_slots) if self._slot_req[s] is None]
            pairs = []
            while free and self._queue:
                pairs.append((free.pop(0), self._queue.popleft()))
            by_bucket: Dict[int, list] = {}
            for slot, req in pairs:
                by_bucket.setdefault(pick_bucket(self.token_buckets, len(req.token_ids)),
                                     []).append((slot, req))
            with torch.no_grad():
                for bucket, group in by_bucket.items():
                    while group:
                        m = 1
                        while m * 2 <= len(group) and m * 2 <= self.n_slots:
                            m *= 2
                        self._admit_group(bucket, group[:m])
                        group = group[m:]
            for slot, req in pairs:
                self.active[slot] = True
                self._done_host[slot] = False
                self._counts_host[slot] = 0
                self._slot_req[slot] = req.req_id
                self._partial[req.req_id] = []
            sp.set(admitted=len(pairs))

    def _segment(self, temperature: float, top_k: int) -> np.ndarray:
        """``segment_frames`` batched frames at ring rows ring_p + j; one
        device read at the end. Returns codes [K, B, 8]."""
        c = self.config
        K, S, B = self.segment_frames, c.max_seq, self.n_slots
        dev = self.device
        with telemetry.span("engine.segment", slot_frames=K * B) as sp:
            counts_before = self._counts_host
            seeds, next_keys = sampling.frame_seeds_batch(self.keys, K)
            self.keys = next_keys
            # Pageable uploads synchronize the stream: the host waits here for
            # admission's device work.
            with telemetry.span("engine.segment.upload"):
                seeds = torch.from_numpy(seeds).to(dev)
                active = torch.from_numpy(self.active).to(dev)
                done = torch.from_numpy(self._done_host).to(dev)
            codes_seg = torch.zeros(K, B, c.num_codebooks, dtype=torch.int32, device=dev)
            self._rows_hi = S if self.ring_p + K > S else max(self._rows_hi, self.ring_p + K)
            pos_emb = self.weights.decoder.pos_emb
            fused = magpie_mod.resolve_use_fused(self.use_fused)
            with telemetry.span("engine.segment.enqueue"):
                for j in range(K):
                    r = (self.ring_p + j) % S
                    alive = active & ~done
                    may_continue = alive & (self.frame_count < c.max_dec_steps)
                    forbid = self.frame_count < c.min_generated_frames
                    posemb = pos_emb[self.logical_pos.clamp(0, c.max_pos - 1).long()]
                    if fused:
                        sampled, argmax, self.hidden, _, _ = frame_step_batched(
                            self.hidden, r, self.valid, may_continue, posemb, self.xa_k,
                            self.xa_v, self.k_cache, self.v_cache, self.weights, c,
                            self.enc_lengths, seeds[j], temperature, top_k, forbid,
                            rows=self._rows_hi)
                    else:
                        sampled, argmax = sample_frame_codes_batched(
                            self.hidden, self.weights, c, seeds[j], temperature, top_k, forbid)
                    is_eos = ((sampled == c.audio_eos_id) | (argmax == c.audio_eos_id)).any(-1)
                    codes_seg[j] = sampled
                    counts = may_continue & ~is_eos
                    self.frame_count += counts.to(torch.int32)
                    done = done | (active & is_eos)
                    # Split path: ring row r's validity is written before the
                    # decoder step attends to it (the fused kernel decides it
                    # inside).
                    self.valid[:, r] = counts
                    if not fused:
                        x_pe = magpie_mod.audio_frame_embedding(sampled, self.weights, c) + posemb
                        self.hidden = decode_step_batched(
                            x_pe, r, self.valid, self.xa_k, self.xa_v, self.k_cache,
                            self.v_cache, self.weights, c, self.enc_lengths, rows=self._rows_hi)
                    self.logical_pos += counts.to(torch.int32)
            self.ring_p = (self.ring_p + K) % S
            with telemetry.span("engine.segment.read"):
                self._counts_host = self.frame_count.cpu().numpy().astype(np.int64)
                self._done_host = done.cpu().numpy().copy()
                codes = codes_seg.cpu().numpy()
            if sp.on:
                sp.set(kept_frames=int((self._counts_host - counts_before).sum()))
        return codes

    def _retire_finished(self, codes_seg: np.ndarray,
                         counts_before: np.ndarray) -> Dict[int, np.ndarray]:
        with telemetry.span("engine.retire") as sp:
            finished = {}
            for slot in range(self.n_slots):
                req_id = self._slot_req[slot]
                if req_id is None:
                    continue
                new = int(self._counts_host[slot] - counts_before[slot])
                if new > 0:
                    self._partial[req_id].append(codes_seg[:new, slot, :])
                hit_cap = self._counts_host[slot] >= self.config.max_dec_steps
                if self._done_host[slot] or hit_cap:
                    parts = self._partial.pop(req_id)
                    codes = (np.concatenate(parts, axis=0) if parts
                             else np.zeros((0, self.config.num_codebooks), np.int32))
                    finished[req_id] = codes
                    self._finished[req_id] = codes
                    self._slot_req[slot] = None
                    self.active[slot] = False
            sp.set(request_ids=list(finished))
            return self._resolve_groups(finished)

    def _resolve_groups(self, finished: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        """Map finished chunk-children onto their parent request: the parent
        id surfaces (codes concatenated in chunk order) once every child is
        done; ungrouped requests pass through unchanged."""
        out: Dict[int, np.ndarray] = {}
        for rid, codes in finished.items():
            parent = self._group_parent.get(rid)
            if parent is None:
                out[rid] = codes
                continue
            children = self._groups[parent]
            if all(ch in self._finished for ch in children):
                joined = np.concatenate([self._finished[ch] for ch in children], axis=0)
                for ch in children:
                    if ch != parent:
                        self._finished.pop(ch, None)
                    self._group_parent.pop(ch, None)
                self._groups.pop(parent)
                self._finished[parent] = joined
                out[parent] = joined
        return out

    # ---- public API -----------------------------------------------------------

    def submit(self, token_ids: Sequence[int], *, speaker_id: int = 0, seed: int = 0,
               submit_ns: Optional[int] = None) -> int:
        """Queue one request; returns its id. Requests longer than the largest
        token bucket split into word-boundary child chunks (child i > 0 gets
        its own id and ``seed + i``); the request id is reported finished once
        all chunks are, with their codes concatenated in order. ``submit_ns``
        (``time.perf_counter_ns``) is when the request arrived, where a server
        in front of the engine queued it first; this call's time by default."""
        if submit_ns is None:
            submit_ns = time.perf_counter_ns()
        chunks = split_to_buckets(token_ids, self.token_buckets, self.split_token_id,
                                  self.config.text_bos_id, self.config.text_eos_id)
        req_id = self._next_id
        self._next_id += 1
        if len(chunks) == 1:
            self._queue.append(_Request(req_id, chunks[0], speaker_id, seed, submit_ns))
            return req_id
        children = []
        for i, chunk in enumerate(chunks):
            child_id = req_id if i == 0 else self._next_id
            if i > 0:
                self._next_id += 1
            children.append(child_id)
            self._group_parent[child_id] = req_id
            self._queue.append(_Request(child_id, chunk, speaker_id, seed + i, submit_ns))
        self._groups[req_id] = children
        return req_id

    @property
    def pending(self) -> int:
        in_flight = sum(1 for r in self._slot_req if r is not None)
        return len(self._queue) + in_flight

    def step(self, *, temperature: float = 0.7, top_k: int = 80) -> Dict[int, np.ndarray]:
        """Admit queued requests, run one segment, retire finished slots.
        Returns {request_id: codes [n_frames, 8]} finished in this segment."""
        with telemetry.span("engine.step"):
            self._admit_pending()
            if not self.active.any():
                return {}
            counts_before = self._counts_host.copy()
            with torch.no_grad():
                codes_seg = self._segment(temperature, top_k)
            return self._retire_finished(codes_seg, counts_before)

    def synthesize_all(self, token_lists: Sequence[Sequence[int]], *,
                       temperature: float = 0.7, top_k: int = 80,
                       seed: int = 0) -> List[np.ndarray]:
        """Convenience: submit everything, pump segments until drained."""
        ids = [self.submit(t, seed=seed) for t in token_lists]
        while self.pending:
            self.step(temperature=temperature, top_k=top_k)
        return [self._finished[i] for i in ids]


class MultiChipContinuousServer:
    """One ContinuousBatchingEngine per device behind a shared host-side
    admission queue. Each request lives entirely on one device, so decoding
    needs no collectives: ``step`` admits from the queue to the engine with
    the most free slots and pumps every busy engine from a thread pool."""

    def __init__(self, weights: MagpieWeights, config: MagpieConfig,
                 devices: Optional[Sequence] = None, slots_per_device: int = 8,
                 compute_dtype=torch.float32, token_buckets: Sequence[int] = (32, 64, 128),
                 segment_frames: int = 32):
        if devices is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("MultiChipContinuousServer: no device given and no CUDA device")
        self.devices = [torch.device(d) for d in devices]
        self.config = config
        self.engines = [ContinuousBatchingEngine(
            weights, config, n_slots=slots_per_device, device=d, compute_dtype=compute_dtype,
            token_buckets=token_buckets, segment_frames=segment_frames) for d in self.devices]
        self._queue: deque = deque()
        self._next_id = 0
        self._to_global: Dict[tuple, int] = {}
        self._finished: Dict[int, np.ndarray] = {}

    def submit(self, token_ids: Sequence[int], *, speaker_id: int = 0, seed: int = 0) -> int:
        gid = self._next_id
        self._next_id += 1
        self._queue.append((gid, list(token_ids), speaker_id, seed, time.perf_counter_ns()))
        return gid

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(e.pending for e in self.engines)

    def _dispatch(self) -> None:
        """Drain the shared queue into the engines with free capacity,
        most-free first."""
        while self._queue:
            caps = [e.n_slots - e.pending for e in self.engines]
            best = int(np.argmax(caps))
            if caps[best] <= 0:
                return
            gid, toks, spk, seed, submit_ns = self._queue.popleft()
            local = self.engines[best].submit(toks, speaker_id=spk, seed=seed,
                                              submit_ns=submit_ns)
            self._to_global[(best, local)] = gid

    def step(self, *, temperature: float = 0.7, top_k: int = 80) -> Dict[int, np.ndarray]:
        """Admit from the shared queue, run one segment on every busy engine
        concurrently, and return {global_request_id: codes} finished now."""
        self._dispatch()
        busy = [(i, e) for i, e in enumerate(self.engines) if e.pending]
        if not busy:
            return {}

        with ThreadPoolExecutor(max_workers=len(busy)) as pool:
            futs = [(i, pool.submit(e.step, temperature=temperature, top_k=top_k))
                    for i, e in busy]
            out: Dict[int, np.ndarray] = {}
            for i, fut in futs:
                for local, codes in fut.result().items():
                    gid = self._to_global.pop((i, local))
                    self._finished[gid] = codes
                    out[gid] = codes
        return out

    def synthesize_all(self, token_lists: Sequence[Sequence[int]], *,
                       temperature: float = 0.7, top_k: int = 80,
                       seed: int = 0) -> List[np.ndarray]:
        ids = [self.submit(t, seed=seed + i) for i, t in enumerate(token_lists)]
        while self.pending:
            self.step(temperature=temperature, top_k=top_k)
        return [self._finished[i] for i in ids]
