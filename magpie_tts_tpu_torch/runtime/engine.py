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
from ..io.magpie_weights import MagpieWeights
from ..models import codec as codec_mod
from ..models import magpie as magpie_mod
from ..ops import sampling

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


def check_dtype(dtype) -> None:
    if dtype != torch.float32:
        raise NotImplementedError(
            f"compute dtype {dtype} is not ported yet: the PyTorch port runs float32 only")


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
    passes False) picks the fused frame kernel or the split path."""

    def __init__(self, weights: MagpieWeights, config: MagpieConfig, device="cuda",
                 compute_dtype=torch.float32,
                 token_buckets: Sequence[int] = DEFAULT_TOKEN_BUCKETS,
                 split_token_id: int = 93, use_fused: Optional[bool] = None):
        check_dtype(compute_dtype)
        self.config = config
        self.use_fused = use_fused
        self.device = resolve_device(device)
        self.weights = weights.to(device=self.device, dtype=compute_dtype)
        self.token_buckets = tuple(token_buckets)
        # Inter-word space token used to split over-long inputs.
        self.split_token_id = split_token_id

    def _pad_tokens(self, token_ids: Sequence[int]):
        n = len(token_ids)
        bucket = pick_bucket(self.token_buckets, n)
        padded = np.zeros(bucket, np.int64)
        padded[:n] = np.asarray(token_ids, np.int64)
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
                self.config, top_k, use_fused=self.use_fused)
            parts.append(codes[:n_frames])
        codes = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        return SynthesisResult(codes=codes, n_frames=codes.shape[0])


class CodecEngine:
    """Nano-codec vocoder with frame bucketing on one device."""

    def __init__(self, weights: CodecWeights, config: CodecConfig, device="cuda",
                 compute_dtype=torch.float32,
                 frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS):
        check_dtype(compute_dtype)
        self.config = config
        self.device = resolve_device(device)
        self.weights = weights.to(device=self.device, dtype=compute_dtype)
        self.frame_buckets = tuple(frame_buckets)

    def decode(self, codes: np.ndarray, pcm16: bool = False) -> np.ndarray:
        """codes: [n_frames, 8] int -> waveform [n_frames * hop]: float32 in
        [-1, 1], or int16 PCM when ``pcm16`` (scaled on the device)."""
        codes = np.asarray(codes, np.int32)
        n = codes.shape[0]
        if n == 0:
            return np.zeros(0, np.int16 if pcm16 else np.float32)
        bucket = pick_bucket(self.frame_buckets, n)
        padded = np.zeros((self.config.num_codebooks, bucket), np.int64)
        padded[:, :n] = codes.T
        with torch.no_grad():
            audio = codec_mod.codec_decode(torch.from_numpy(padded).to(self.device),
                                           self.weights, self.config)
            audio = audio[: n * self.config.hop_length]
            if pcm16:
                audio = (torch.clamp(audio.float(), -1.0, 1.0) * 32767.0).to(torch.int16)
        return audio.cpu().numpy()

    def decode_batch(self, codes_list) -> list:
        """Vocode several utterances in one batched codec call (padded to the
        bucket of the longest). Returns float32 waveforms [n_i * hop]."""
        if not codes_list:
            return []
        lens = [np.asarray(c).shape[0] for c in codes_list]
        bucket = pick_bucket(self.frame_buckets, max(max(lens), 1))
        padded = np.zeros((len(codes_list), self.config.num_codebooks, bucket), np.int64)
        for i, c in enumerate(codes_list):
            padded[i, :, :lens[i]] = np.asarray(c, np.int64).T
        with torch.no_grad():
            codes = torch.from_numpy(padded).to(self.device)
            latent = codec_mod.fsq_dequantize(codes, self.config).to(self.weights.pre_conv_w.dtype)
            audio = codec_mod.codec_decode_latent(latent.contiguous(), self.weights,
                                                  self.config).float().cpu().numpy()
        hop = self.config.hop_length
        return [audio[i, :lens[i] * hop] for i in range(len(codes_list))]


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
