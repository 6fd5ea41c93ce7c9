"""MagpiePipeline: model files -> text -> waveform, on an explicit device."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from .config import MagpieConfig
from .io.codec_weights import load_codec_weights
from .io.magpie_weights import load_magpie_weights, q8_stream_from_gguf
from .io.native import open_gguf
from .io.wav import write_wav
from .runtime import streaming
from .runtime.engine import CodecEngine, MagpieEngine, check_dtype
from .text.tokenizer import MagpieTokenizer


@dataclasses.dataclass
class MagpiePipeline:
    tokenizer: MagpieTokenizer
    engine: MagpieEngine
    codec: Optional[CodecEngine]
    config: MagpieConfig

    @classmethod
    def from_gguf(cls, model_path: str, codec_path: Optional[str] = None,
                  device="cuda", compute_dtype=torch.float32,
                  gelu_flavor: Optional[str] = None,
                  use_fused: Optional[bool] = None, serve_int8: bool = False,
                  serve_q8: bool = False) -> "MagpiePipeline":
        """Load the model (and codec) GGUFs onto ``device``; the tokenizer comes
        from the model GGUF's metadata. ``gelu_flavor`` ("erf" / "tanh")
        overrides the config's GELU in every FFN; ``use_fused`` goes to the
        engine (False: the split decode path).

        ``serve_int8``: stream the four per-frame decoder matrices as
        per-column int8. ``serve_q8`` (needs a Q8_0 GGUF, else ValueError):
        serve the file's own Q8_0 blocks, with no requantization error. The
        four per-frame decoder matrices stream natively in the kernels
        (Q8DecoderStream), and every other allowlisted tensor stays as its
        blocks (Q8Blocks), dequantized at program entry."""
        check_dtype(compute_dtype)
        reader = open_gguf(model_path)
        config, weights = load_magpie_weights(model_path, reader=reader, q8_native=serve_q8)
        if gelu_flavor is not None:
            config = dataclasses.replace(config, gelu_flavor=gelu_flavor)
        tokenizer = MagpieTokenizer.from_gguf_metadata(reader.metadata)
        q8_stream = q8_stream_from_gguf(reader, config) if serve_q8 else None
        engine = MagpieEngine(weights, config, device=device, compute_dtype=compute_dtype,
                              split_token_id=tokenizer.space_id, use_fused=use_fused,
                              serve_int8=serve_int8, q8_stream=q8_stream)
        codec = None
        if codec_path:
            codec_config, codec_weights = load_codec_weights(codec_path)
            codec = CodecEngine(codec_weights, codec_config, device=device,
                                compute_dtype=compute_dtype)
        return cls(tokenizer=tokenizer, engine=engine, codec=codec, config=config)

    def synthesize_codes(self, text: str, *, speaker_id: int = 0,
                         temperature: float = 0.7, top_k: int = 80,
                         seed: int = 0) -> np.ndarray:
        token_ids = self.tokenizer.encode(text)
        return self.engine.synthesize_codes(
            token_ids, speaker_id=speaker_id, temperature=temperature,
            top_k=top_k, seed=seed).codes

    def _codec(self) -> CodecEngine:
        if self.codec is None:
            raise ValueError("no codec loaded; pass codec_path to from_gguf")
        return self.codec

    def synthesize(self, text: str, *, speaker_id: int = 0, temperature: float = 0.7,
                   top_k: int = 80, seed: int = 0) -> np.ndarray:
        """text -> float32 waveform at config.sample_rate."""
        codec = self._codec()
        return codec.decode(self.synthesize_codes(text, speaker_id=speaker_id,
                                                  temperature=temperature, top_k=top_k,
                                                  seed=seed))

    def synthesize_to_wav(self, text: str, output_path: str, **kwargs) -> int:
        """text -> 16-bit PCM WAV (PCM16 made on the device); returns the
        number of samples."""
        codec = self._codec()
        samples = codec.decode(self.synthesize_codes(text, **kwargs), pcm16=True)
        write_wav(output_path, samples, self.config.sample_rate)
        return len(samples)

    def warmup(self, *, streaming_path: bool = False, top_k: int = 80,
               token_buckets: Optional[Sequence[int]] = None,
               params: Optional[streaming.StreamParams] = None) -> None:
        """Build the kernels and run the offline path (or, with
        ``streaming_path``, the streaming chunks) once per token bucket."""
        if streaming_path:
            streaming.warmup_streaming(self.engine, self._codec(), params,
                                       token_buckets=token_buckets)
        else:
            self.engine.warmup(token_buckets=token_buckets, top_k=top_k)

    def stream(self, text: str, params: Optional[streaming.StreamParams] = None
               ) -> Iterator[streaming.AudioChunk]:
        return streaming.stream_text(self.engine, self._codec(), self.tokenizer, text,
                                     params or streaming.StreamParams())
