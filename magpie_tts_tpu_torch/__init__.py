"""magpie_tts_tpu_torch — the PyTorch/CUDA port of magpie_tts_tpu.

Same module layout as the JAX package; the decode frame and the codec
convolutions run hand-written CUDA kernels (csrc/) on an NVIDIA Hopper card,
and their plain PyTorch versions on the CPU. This package never imports jax.
"""

from .config import CodecConfig, MagpieConfig
from .pipeline import MagpiePipeline
from .runtime.engine import CodecEngine, MagpieEngine
from .text.tokenizer import MagpieTokenizer

__version__ = "0.1.0"

__all__ = ["CodecConfig", "CodecEngine", "MagpieConfig", "MagpieEngine",
           "MagpiePipeline", "MagpieTokenizer"]
