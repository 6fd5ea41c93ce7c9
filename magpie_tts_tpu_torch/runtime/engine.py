"""MagpieEngine / CodecEngine (magpie_tts_tpu/runtime/engine.py) on an explicit device.

Token and frame buckets are kept from the JAX package: the encoder and the
codec are causal, so right-padding to a bucket cannot change the valid
prefix, and bucketed shapes keep a later CUDA-graph capture to a few shapes.
Inputs longer than the largest token bucket are split at word boundaries.

There is no device fallback: an engine runs where it is told to, and a CUDA
device that is not there is an error.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CodecConfig, MagpieConfig
from ..io.codec_weights import CodecWeights
from ..io.magpie_weights import (MagpieWeights, Q8DecoderStream, materialize_weights,
                                 quantize_decoder_stream)
from ..models import codec as codec_mod
from ..models import magpie as magpie_mod
from ..ops import sampling
from . import telemetry

DEFAULT_TOKEN_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512)
DEFAULT_FRAME_BUCKETS = (32, 64, 128, 256, 384, 512)


def resolve_device(device) -> torch.device:
    """Validate the engine device. On CUDA, float32 matmuls and convolutions
    run in full float32 (no TF32): the counterpart of the JAX package's
    DOT_PRECISION = HIGHEST (magpie_tts_tpu/ops/precision.py)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)  # what the engines and kernels take


def check_dtype(dtype) -> None:
    if dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute dtype {dtype} is not ported: the PyTorch port runs float32 and "
            f"bfloat16")


def pick_bucket(buckets: Sequence[int], n: int) -> int:
    idx = bisect.bisect_left(buckets, n)
    if idx == len(buckets):
        raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")
    return buckets[idx]


def split_to_buckets(token_ids: Sequence[int], buckets: Sequence[int],
                     split_id: int, bos_id: int, eos_id: int):
    """Token lists longer than the largest bucket become several <=bucket
    chunks split at word boundaries; shorter ones pass through whole."""
    from ..text.tokenizer import chunk_token_ids

    return chunk_token_ids(list(token_ids), buckets[-1], split_id, bos_id, eos_id)


@dataclasses.dataclass
class SynthesisResult:
    codes: np.ndarray       # [n_frames, 8] int32
    n_frames: int


class MagpieEngine:
    """TTS code generation for one model instance on one device.
    ``use_fused`` (None: fused unless MAGPIE_NO_FUSED; the CLI's --no-fused
    passes False) picks the fused frame kernel or the split path.

    The four decoder matrices a frame streams can be served quantized, through
    the kernels' one stream slot: ``serve_int8`` quantizes them per column
    (a serving requantization, ~Q8 error), ``q8_stream`` serves a Q8_0
    checkpoint's own blocks (``io.magpie_weights.q8_stream_from_gguf``: codes
    exactly equal to the dequantize-at-load path). The two exclude each
    other."""

    def __init__(self, weights: MagpieWeights, config: MagpieConfig, device="cuda",
                 compute_dtype=torch.float32,
                 token_buckets: Sequence[int] = DEFAULT_TOKEN_BUCKETS,
                 split_token_id: int = 93, use_fused: Optional[bool] = None,
                 serve_int8: bool = False, q8_stream: Optional[Q8DecoderStream] = None):
        check_dtype(compute_dtype)
        if serve_int8 and q8_stream is not None:
            raise ValueError("serve_int8 and q8_stream are mutually exclusive")
        self.config = config
        self.use_fused = use_fused
        self.device = resolve_device(device)
        self.weights = weights.to(device=self.device, dtype=compute_dtype)
        # What prepare multiplies with: bf16 products on float32 copies of
        # dense weights (None: the weights themselves). Q8_0 blocks
        # (--serve-q8) materialize per call and their prepare widens per
        # product: a copy kept for the engine's life would hold what the
        # blocks save.
        prep = magpie_mod.float32_products(self.weights)
        self.prepare_weights = None if prep is self.weights else prep
        # begin_stream's prepare: on a card a CUDA graph a token bucket,
        # captured on these weights (Q8_0 blocks dequantize inside it).
        self._prepare = magpie_mod.PrepareGraphs(self.prepare_weights or self.weights, config)
        self.int8_stream = None
        if q8_stream is not None:
            self.int8_stream = q8_stream.to(self.device)
        elif serve_int8:
            with torch.no_grad():
                dec = materialize_weights(self.weights).decoder
                self.int8_stream = quantize_decoder_stream(dec)
        self.token_buckets = tuple(token_buckets)
        # Inter-word space token used to split over-long inputs.
        self.split_token_id = split_token_id

    def _pad_host(self, token_ids: Sequence[int]):
        """(token ids right-padded to their bucket, an int64 host array; n)."""
        n = len(token_ids)
        padded = np.zeros(pick_bucket(self.token_buckets, n), np.int64)
        padded[:n] = np.asarray(token_ids, np.int64)
        return padded, n

    def _pad_tokens(self, token_ids: Sequence[int]):
        padded, n = self._pad_host(token_ids)
        return torch.from_numpy(padded).to(self.device), n

    def synthesize_codes(self, token_ids: Sequence[int], *, speaker_id: int = 0,
                         temperature: float = 0.7, top_k: int = 80,
                         seed: int = 0) -> SynthesisResult:
        """Generate audio codes for one tokenized utterance.

        Chunk 0 samples with ``PRNGKey(seed)``, chunk i > 0 with
        ``fold_in(PRNGKey(seed), i)`` — the JAX engine's keys."""
        chunks = split_to_buckets(token_ids, self.token_buckets, self.split_token_id,
                                  self.config.text_bos_id, self.config.text_eos_id)
        parts = []
        for i, chunk in enumerate(chunks):
            tokens, enc_length = self._pad_tokens(chunk)
            key = sampling.prng_key(seed)
            if i > 0:
                key = sampling.fold_in(key, i)
            codes, n_frames = magpie_mod.synthesize_codes_program(
                tokens, enc_length, speaker_id, key, temperature, self.weights,
                self.config, top_k, use_fused=self.use_fused, int8_stream=self.int8_stream,
                prepare_weights=self.prepare_weights)
            parts.append(codes[:n_frames])
        codes = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        return SynthesisResult(codes=codes, n_frames=codes.shape[0])

    def warmup(self, *, token_buckets: Optional[Sequence[int]] = None, top_k: int = 80,
               streaming: bool = False, codec: Optional["CodecEngine"] = None,
               split_stream: bool = False) -> None:
        """Build the kernel library (on a CUDA device) and run synthesis once
        per token bucket (default: all), so no request pays the nvcc build
        or a first run; the port has no compilation cache.

        ``streaming=True`` runs the streaming path (``runtime.streaming``)
        instead and needs the ``codec``; ``split_stream=True`` runs
        ``begin_stream`` + one ``decode_chunk`` frame per bucket."""
        _load_kernels(self.device)
        if streaming:
            if codec is None:
                raise ValueError("warmup(streaming=True) runs the streaming chunks, which "
                                 "need the codec: pass codec=<CodecEngine>")
            from . import streaming as streaming_mod

            streaming_mod.warmup_streaming(self, codec, token_buckets=token_buckets)
            return
        for bucket in (token_buckets or self.token_buckets):
            tokens = [self.config.text_bos_id, self.config.text_eos_id]
            tokens += [2] * (bucket - len(tokens))
            if split_stream:
                stream = self.begin_stream(tokens)
                self.decode_chunk(stream, n_frames=1, top_k=top_k)
            else:
                self.synthesize_codes(tokens, top_k=top_k, temperature=0.0)

    def begin_stream(self, token_ids: Sequence[int], *, speaker_id: int = 0) -> dict:
        """Prefill for incremental decoding (token_ids must fit a bucket):
        ``prepare`` as the M = 1 replay of the bucket's graph on a card
        (``PrepareGraphs``), whose outputs the stream copies or clones, so a
        later stream's replay leaves them alone. Returns the stream context
        ``decode_chunk`` advances; it holds the dense weights (``--serve-q8``
        blocks dequantized once per stream)."""
        with telemetry.span("stream.prepare") as sp, torch.no_grad():
            tokens, enc_length = self._pad_host(token_ids)
            (xa_k, xa_v, k_rows, v_rows, hidden), mode = self._prepare(
                tokens[None], [enc_length], [speaker_id])
            sp.set(graph=mode)
            state = magpie_mod.decode_state(k_rows[0], v_rows[0], hidden[0].clone(), self.config)
            weights = materialize_weights(self.weights)
        return {"xa_k": xa_k[0].clone(), "xa_v": xa_v[0].clone(), "state": state,
                "enc_length": enc_length, "weights": weights, "chunk_idx": 0}

    def decode_chunk(self, stream: dict, *, n_frames: int, temperature: float = 0.7,
                     top_k: int = 80, seed: int = 0) -> Tuple[np.ndarray, bool]:
        """Advance the stream by up to ``n_frames`` frames, sampling with
        ``fold_in(PRNGKey(seed), chunk_idx)`` (the JAX engine's chunk keys).

        Returns (new_codes [m, 8], done), m <= n_frames; done once EOS fired
        or ``max_dec_steps`` frames were made."""
        state = stream["state"]
        start = state.frame_idx
        key = sampling.fold_in(sampling.prng_key(seed), stream["chunk_idx"])
        with telemetry.span("stream.chunk") as sp, torch.no_grad():
            state = magpie_mod.decode_loop(
                stream["xa_k"], stream["xa_v"], state, stream["enc_length"], stream["weights"],
                self.config, key, temperature, top_k, use_fused=self.use_fused,
                int8_stream=self.int8_stream, target_frames=start + n_frames)
            sp.set(frames=state.frame_idx - start)
        stream["state"] = state
        stream["chunk_idx"] += 1
        end = state.frame_idx
        return state.codes[start:end].copy(), state.done or end >= self.config.max_dec_steps


def _load_kernels(device: torch.device) -> None:
    """Build (or load) the kernel library when ``device`` is a card."""
    if device.type == "cuda":
        from ..ops.kernels import build

        build.load_library()


class CodecEngine:
    """Nano-codec vocoder with frame bucketing on one device. Under
    MAGPIE_FUSED_CODEC its res layers of <= 128 channels run the fused
    kernel on weights stacked once per engine."""

    def __init__(self, weights: CodecWeights, config: CodecConfig, device="cuda",
                 compute_dtype=torch.float32,
                 frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS):
        check_dtype(compute_dtype)
        self.config = config
        self.device = resolve_device(device)
        self.weights = weights.to(device=self.device, dtype=compute_dtype)
        self.frame_buckets = tuple(frame_buckets)
        self._fused_layers = None

    def _fused(self):
        """The stages' stacked res layers when MAGPIE_FUSED_CODEC is set
        (stacked at the first such call), else None."""
        if not codec_mod.resolve_fused_codec():
            return None
        if self._fused_layers is None:
            with torch.no_grad():
                self._fused_layers = codec_mod.fused_layers(self.weights, self.config)
        return self._fused_layers

    def decode(self, codes: np.ndarray, pcm16: bool = False, bucket: bool = True) -> np.ndarray:
        """codes: [n_frames, 8] int -> waveform [n_frames * hop]: float32 in
        [-1, 1], or int16 PCM when ``pcm16`` (scaled on the device). The
        codes are padded to a frame bucket unless ``bucket`` is False
        (streaming windows: a fixed shape of their own)."""
        codes = np.asarray(codes, np.int32)
        n = codes.shape[0]
        if n == 0:
            return np.zeros(0, np.int16 if pcm16 else np.float32)
        with telemetry.span("codec.decode"), torch.no_grad():
            frames = pick_bucket(self.frame_buckets, n) if bucket else n
            padded = np.zeros((self.config.num_codebooks, frames), np.int64)
            padded[:, :n] = codes.T
            audio = codec_mod.codec_decode(torch.from_numpy(padded).to(self.device),
                                           self.weights, self.config, self._fused())
            audio = audio[: n * self.config.hop_length]
            audio = audio.float()
            if pcm16:
                audio = (torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16)
            with telemetry.span("codec.read"):
                return audio.cpu().numpy()

    def decode_batch(self, codes_list) -> list:
        """Vocode several utterances in one batched codec call (padded to the
        bucket of the longest). Returns float32 waveforms [n_i * hop]."""
        if not codes_list:
            return []
        lens = [np.asarray(c).shape[0] for c in codes_list]
        bucket = pick_bucket(self.frame_buckets, max(max(lens), 1))
        with telemetry.span("codec.decode_batch", requests=len(lens), frames=sum(lens),
                            vocoded=len(lens) * bucket), torch.no_grad():
            padded = np.zeros((len(codes_list), self.config.num_codebooks, bucket), np.int64)
            for i, c in enumerate(codes_list):
                padded[i, :, :lens[i]] = np.asarray(c, np.int64).T
            codes = torch.from_numpy(padded).to(self.device)
            latent = codec_mod.fsq_dequantize(codes, self.config).to(self.weights.pre_conv_w.dtype)
            audio = codec_mod.codec_decode_latent(latent.contiguous(), self.weights,
                                                  self.config, self._fused())
            audio = audio.float()
            with telemetry.span("codec.read"):
                audio = audio.cpu().numpy()
        hop = self.config.hop_length
        return [audio[i, :lens[i] * hop] for i in range(len(codes_list))]

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Build the kernel library (on a CUDA device) and decode once per
        frame bucket (default: all)."""
        _load_kernels(self.device)
        for bucket in (buckets or self.frame_buckets):
            self.decode(np.zeros((bucket, self.config.num_codebooks), np.int32))

    def decode_with_context(self, codes: np.ndarray, n_context: int) -> np.ndarray:
        """Decode [context; new] frames and return only the new frames'
        samples: the vocoder is causal with a bounded left receptive field, so
        enough context makes them equal to a full decode's."""
        return self.decode(codes)[n_context * self.config.hop_length:]


def synthesize_audio_fused(engine: MagpieEngine, codec: CodecEngine,
                           token_ids: Sequence[int], *, speaker_id: int = 0,
                           temperature: float = 0.7, top_k: int = 80,
                           seed: int = 0) -> Tuple[np.ndarray, int]:
    """tokens -> 16-bit PCM: codes, then the vocoder, then PCM16 (the JAX
    package's one-dispatch surface, here a plain composition). Over-long
    input synthesizes chunk i with ``seed + i``, as the JAX surface does.

    Returns (int16 samples [n_frames * hop], n_frames)."""
    chunks = split_to_buckets(token_ids, engine.token_buckets, engine.split_token_id,
                              engine.config.text_bos_id, engine.config.text_eos_id)
    if len(chunks) > 1:
        parts = [synthesize_audio_fused(engine, codec, c, speaker_id=speaker_id,
                                        temperature=temperature, top_k=top_k, seed=seed + i)
                 for i, c in enumerate(chunks)]
        return np.concatenate([p[0] for p in parts]), sum(p[1] for p in parts)
    result = engine.synthesize_codes(token_ids, speaker_id=speaker_id,
                                     temperature=temperature, top_k=top_k, seed=seed)
    return codec.decode(result.codes, pcm16=True), result.n_frames
