"""Streaming synthesis (magpie_tts_tpu/runtime/streaming.py): sentence
chunking and audio emitted every ``frames_per_chunk`` frames, as a generator
plus a callback wrapper.

Each chunk is vocoded with ``codec_context_frames`` of already-emitted frames
before it. The vocoder is causal with a bounded left receptive field (~25
frames for the production codec, under the default 32), and every codec
kernel computes a row by the same arithmetic wherever the window starts, so
the emitted audio equals a full offline decode's.

The JAX package folds prepare, the chunk's frames and the window's vocode
into one compiled program per chunk to save TPU round trips; here the same
steps run one after another: ``MagpieEngine.begin_stream`` on the first
chunk, ``decode_chunk`` (``decode_loop`` up to ``start + k`` frames), then
``CodecEngine.decode`` of exactly the ``[base, base + win)`` window.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional

import numpy as np

from . import telemetry
from .engine import CodecEngine, MagpieEngine, split_to_buckets

_SENTENCE_ENDINGS = ".!?"
_WHITESPACE = " \t\n\r"


def split_sentences(text: str) -> List[str]:
    """Split on ./!/? followed by whitespace or the end of the text."""
    sentences: List[str] = []
    current: List[str] = []
    for i, ch in enumerate(text):
        current.append(ch)
        nxt = text[i + 1] if i + 1 < len(text) else ""
        if ch in _SENTENCE_ENDINGS and (nxt == "" or nxt in _WHITESPACE):
            sentence = "".join(current).lstrip(_WHITESPACE)
            if sentence:
                sentences.append(sentence)
            current = []
    tail = "".join(current).lstrip(_WHITESPACE)
    if tail:
        sentences.append(tail)
    return sentences


@dataclasses.dataclass
class StreamParams:
    temperature: float = 0.7
    top_k: int = 80
    speaker_id: int = 0
    frames_per_chunk: int = 4
    sentence_chunking: bool = True
    seed: int = 0
    codec_context_frames: int = 32  # left context for seamless chunked vocoding


@dataclasses.dataclass
class AudioChunk:
    samples: np.ndarray      # float32 mono at config.sample_rate
    sentence_index: int
    total_sentences: int
    frames_generated: int    # cumulative frames in this sentence
    is_sentence_end: bool


def stream_sentence(engine: MagpieEngine, codec: CodecEngine, token_ids,
                    params: StreamParams, sentence_index: int = 0,
                    total_sentences: int = 1) -> Iterator[AudioChunk]:
    """Synthesize one tokenized sentence (at most the largest token bucket)
    chunk by chunk, yielding each chunk's new audio. Chunk i samples with
    ``fold_in(PRNGKey(seed), i)``, chunk 0 included. Two chunks in a row that
    make no frame and no EOS raise."""
    k = params.frames_per_chunk
    ctx = params.codec_context_frames
    max_steps = engine.config.max_dec_steps
    win = min(ctx + k, max_steps)
    hop = codec.config.hop_length
    stream = engine.begin_stream(token_ids, speaker_id=params.speaker_id)
    stalls = 0
    done = False
    while not done:
        start = stream["state"].frame_idx
        _, done = engine.decode_chunk(stream, n_frames=k, temperature=params.temperature,
                                      top_k=params.top_k, seed=params.seed)
        end = stream["state"].frame_idx
        n_new = end - start
        if n_new <= 0:
            if done:
                break
            # A live stream must advance every chunk; asking again forever
            # would hang the caller.
            stalls += 1
            if stalls >= 2:
                raise RuntimeError(
                    "streaming decode made no progress (frame_idx stuck at "
                    f"{end}) — decode_loop returned neither frames nor EOS")
            continue
        stalls = 0
        base = min(max(start - ctx, 0), max_steps - win)
        with telemetry.span("stream.vocode", frames=n_new, vocoded=win):
            audio = codec.decode(stream["state"].codes[base:base + win], bucket=False)
        off = start - base
        yield AudioChunk(samples=audio[off * hop:(off + n_new) * hop],
                         sentence_index=sentence_index, total_sentences=total_sentences,
                         frames_generated=end, is_sentence_end=done)


def warmup_streaming(engine: MagpieEngine, codec: CodecEngine,
                     params: Optional[StreamParams] = None, token_buckets=None) -> None:
    """Run the streaming path once per token bucket: two chunks each (the
    first chunk with prepare, then a steady one), then drop the stream."""
    params = params or StreamParams()
    for bucket in (token_buckets or engine.token_buckets):
        tokens = [engine.config.text_bos_id] + [2] * (bucket - 2) + [engine.config.text_eos_id]
        for i, _ in enumerate(stream_sentence(engine, codec, tokens, params)):
            if i >= 1:
                break


def stream_text(engine: MagpieEngine, codec: CodecEngine, tokenizer, text: str,
                params: StreamParams) -> Iterator[AudioChunk]:
    """Sentence-chunked streaming over any text; a sentence longer than the
    largest token bucket is split at word boundaries (``split_to_buckets``)."""
    sentences = split_sentences(text) if params.sentence_chunking else [text]
    for idx, sentence in enumerate(sentences):
        token_ids = tokenizer.encode(sentence)
        for piece in split_to_buckets(token_ids, engine.token_buckets, engine.split_token_id,
                                      engine.config.text_bos_id, engine.config.text_eos_id):
            yield from stream_sentence(engine, codec, piece, params, sentence_index=idx,
                                       total_sentences=len(sentences))


def synthesize_streaming(engine: MagpieEngine, codec: CodecEngine, tokenizer, text: str,
                         params: StreamParams, on_audio: Callable[[np.ndarray], bool],
                         on_progress: Optional[Callable[[int, int, int], None]] = None) -> int:
    """Callback form: ``on_audio`` gets each chunk's samples and returning
    False aborts. Returns the total samples, or -1 if aborted."""
    total = 0
    for chunk in stream_text(engine, codec, tokenizer, text, params):
        if on_progress is not None:
            on_progress(chunk.frames_generated, chunk.sentence_index, chunk.total_sentences)
        if not on_audio(chunk.samples):
            return -1
        total += len(chunk.samples)
    return total
