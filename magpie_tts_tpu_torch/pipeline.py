"""MagpiePipeline: model files -> text -> waveform, on an explicit device."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import MagpieConfig
from .io.codec_weights import load_codec_weights
from .io.gguf import GGUFReader
from .io.magpie_weights import load_magpie_weights
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
                  use_fused: Optional[bool] = None) -> "MagpiePipeline":
        """Load the model (and codec) GGUFs onto ``device``; the tokenizer comes
        from the model GGUF's metadata. ``gelu_flavor`` ("erf" / "tanh")
        overrides the config's GELU in every FFN; ``use_fused`` goes to the
        engine (False: the split decode path)."""
        check_dtype(compute_dtype)
        reader = GGUFReader(model_path)
        config, weights = load_magpie_weights(model_path, reader=reader)
        if gelu_flavor is not None:
            config = dataclasses.replace(config, gelu_flavor=gelu_flavor)
        tokenizer = MagpieTokenizer.from_gguf_metadata(reader.metadata)
        engine = MagpieEngine(weights, config, device=device, compute_dtype=compute_dtype,
                              split_token_id=tokenizer.space_id, use_fused=use_fused)
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
