"""PyTorch port, kernel 9 (the fused codec res layer, ``MAGPIE_FUSED_CODEC``):
its plain version against the Pallas kernel it replaces in interpret mode
(float32 here, bfloat16 in a child process without XLA's excess precision)
and against the JAX per-conv res layer, the codec with the switch against
JAX's with the switch, and the switch reaching the wrapper on every codec
path, on the CPU. The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magpie_tts_tpu.config import CodecConfig
from magpie_tts_tpu.io.codec_weights import random_codec_weights as j_random_codec
from magpie_tts_tpu.models import codec as jcodec
from magpie_tts_tpu.ops.pallas_kernels import codec_conv as jcc
from magpie_tts_tpu.ops.pallas_kernels import codec_res_fused as jcrf
from magpie_tts_tpu_torch.models import codec as tcodec
from magpie_tts_tpu_torch.ops.kernels import codec_res_fused as crf
from magpie_tts_tpu_torch.runtime.engine import CodecEngine
from magpie_tts_tpu_torch.runtime.streaming import StreamParams, stream_sentence
from tests.test_torch_support import jax_reference_without_excess_precision, port_codec_weights
from tests.utils import tiny_codec_config

STAGES = [(2, 108), (3, 54), (4, 27)]   # the stages of at most 128 channels
T, TILE = 300, 256                      # across a tile boundary, not a multiple of it
# Float32 bars are relative: a layer's output reaches |x| ~ 668 at C = 108 and
# ~ 15 at C = 27 (seed 3), and the Pallas kernel's sums (packed lanes, another
# order) differ from torch's conv by ~1e-6 of that.
REL = 1e-5
# bfloat16 against the Pallas kernel, in scaled bf16 ulps (the ulp of
# max(|value|, its row's RMS)): float32 sums in another order move a rounding
# by one ulp now and then, and each later conv spreads it. The kernel's
# _fast_sin and reciprocal alpha add to that. Measured on this input: 98.5%
# (C = 108), 99.8% (54), 99.8% (27) within 1 ulp, at most 3.
BF16_SHARE, BF16_MAX = 0.95, 8


@pytest.fixture(scope="module")
def prod_codec():
    cfg = CodecConfig()
    jw = j_random_codec(cfg, seed=3)
    return cfg, jw, port_codec_weights(jw)


def _x(C: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 0.5, size=(T, C)).astype(np.float32)


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("stage,C", STAGES)
def test_plain_matches_pallas_interpret(prod_codec, stage, C):
    cfg, jw, pw = prod_codec
    x = _x(C)
    want = jcrf.res_layer_fused(jnp.asarray(x), jw.stages[stage].resblocks,
                                cfg.resblock_dilations, cfg.leaky_slope, tile=TILE,
                                interpret=True)
    layer = crf.stack_res_layer(pw.stages[stage].resblocks, cfg.resblock_dilations)
    with torch.no_grad():
        got = crf.res_layer_fused(torch.from_numpy(x)[None], layer, cfg.leaky_slope)[0]
    assert _rel_err(got.numpy(), want) <= REL


@pytest.mark.parametrize("stage,C", STAGES)
def test_plain_matches_jax_per_conv_res_layer(prod_codec, stage, C):
    """In float32 the fused function is the per-conv res layer's."""
    cfg, jw, pw = prod_codec
    x = _x(C, seed=1)[None]
    want = jcodec.res_layer(jnp.asarray(x), jw.stages[stage].resblocks, cfg.resblock_dilations,
                            cfg.leaky_slope, use_pallas=False)
    layer = crf.stack_res_layer(pw.stages[stage].resblocks, cfg.resblock_dilations)
    with torch.no_grad():
        got = crf.res_layer_fused_reference(torch.from_numpy(x), layer, cfg.leaky_slope)
        per_conv = tcodec.res_layer(torch.from_numpy(x), pw.stages[stage].resblocks,
                                    cfg.resblock_dilations, cfg.leaky_slope)
    assert _rel_err(got.numpy(), want) <= REL
    assert torch.equal(got, per_conv)


def jax_fused_bf16_reference() -> dict:
    """The Pallas kernel in bfloat16 (interpret mode) on each stage, with the
    weights cast to bfloat16 (run in the child process of
    jax_reference_without_excess_precision)."""
    cfg = CodecConfig()
    jw = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), j_random_codec(cfg, seed=3))
    out = {}
    for stage, C in STAGES:
        x = jnp.asarray(_x(C, seed=2), jnp.bfloat16)
        y = jcrf.res_layer_fused(x, jw.stages[stage].resblocks, cfg.resblock_dilations,
                                 cfg.leaky_slope, tile=TILE, interpret=True)
        out[f"y{C}"] = np.asarray(y.astype(jnp.float32))
    return out


def scaled_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    g, w = got.float(), want.float()
    ref = torch.maximum(w.abs(), w.pow(2).mean(-1, keepdim=True).sqrt()).clamp_min(1e-30)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(ref)) - 7)


def test_plain_matches_pallas_interpret_bf16(prod_codec):
    cfg, _, pw = prod_codec
    ref = jax_reference_without_excess_precision(
        "tests.test_torch_codec_fused:jax_fused_bf16_reference")
    bw = pw.to(dtype=torch.bfloat16)
    for stage, C in STAGES:
        layer = crf.stack_res_layer(bw.stages[stage].resblocks, cfg.resblock_dilations)
        x = torch.from_numpy(_x(C, seed=2)).to(torch.bfloat16)[None]
        with torch.no_grad():
            got = crf.res_layer_fused(x, layer, cfg.leaky_slope)[0]
        assert got.dtype == torch.bfloat16
        u = scaled_ulps(got, torch.from_numpy(ref[f"y{C}"]))
        share, most = float((u <= 1).float().mean()), float(u.max())
        assert share >= BF16_SHARE and most <= BF16_MAX, (C, share, most)


def test_stacked_layer_and_tiles(prod_codec):
    """The stack: 18 convs in branch order (in-conv, sk-conv per block), the
    halo of the k = 11 branch, and the tiles the kernel would take at a
    32-frame decode's shapes on a 132-SM card (shared memory and register
    sums fit; results do not depend on the tile)."""
    cfg, _, pw = prod_codec
    layers = tcodec.fused_layers(pw, cfg)
    assert [la is None for la in layers] == [True, True, False, False, False]
    layer = layers[2]
    assert layer.channels == 108 and layer.n_branches == 3 and len(layer.convs) == 18
    assert layer.halo == 120
    assert layer.meta[:2] == (3, 6) and layer.meta[2:8] == (3, 1, 54, 3, 1, 54)
    assert layer.w.numel() == 126 * 108 * 108
    blk = pw.stages[2].resblocks[1][2]
    assert torch.equal(layer.alpha[10, :54], blk.in_alpha)
    assert torch.all(layer.alpha[10, 54:] == 1)
    assert torch.equal(layer.bias[11], blk.sk_conv_b)
    picks = [crf.pick_tile(1, T_, la, 132) for T_, la in zip((8192, 16384, 32768), layers[2:])]
    assert picks == [64, 128, 256]
    assert crf.pick_tile(3, 8192, layer, 132) == 64
    assert crf.smem_bytes(64, 120, 108, torch.float32) <= 232448 and not crf._fits(256, layer)


def test_codec_decode_with_switch_matches_jax_with_switch(monkeypatch):
    """codec_decode under MAGPIE_FUSED_CODEC against JAX's Pallas codec under
    the same switch in interpret mode, and against the port without the
    switch, on a two-stage tiny codec (both stages fused; interpret mode
    takes ~7 s a layer)."""
    cfg = tiny_codec_config(hop_length=8, up_sample_rates=(4, 2), up_channels=(32, 16),
                            up_kernels=(8, 4))
    jw = j_random_codec(cfg, seed=2)
    pw = port_codec_weights(jw)
    codes = np.random.default_rng(5).integers(0, cfg.codebook_size, size=(8, 12)).astype(np.int32)
    for mod, name in ((jcc, "snake_causal_conv"), (jcc, "snake_causal_conv_packed"),
                      (jcrf, "res_layer_fused")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _o=orig, **kw: _o(*a, **{**kw, "interpret": True}))
    monkeypatch.setenv("MAGPIE_FUSED_CODEC", "1")
    want = jcodec.codec_decode(jnp.asarray(codes), jw, cfg, use_pallas=True)
    with torch.no_grad():
        got = tcodec.codec_decode(torch.from_numpy(codes), pw, cfg)
        monkeypatch.delenv("MAGPIE_FUSED_CODEC")
        per_conv = tcodec.codec_decode(torch.from_numpy(codes), pw, cfg)
    assert got.shape == (12 * cfg.hop_length,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), per_conv.numpy(), atol=1e-6, rtol=0)


def _tiny_engine():
    cfg = tiny_codec_config()
    return CodecEngine(port_codec_weights(j_random_codec(cfg, seed=2)), cfg, device="cpu",
                       frame_buckets=(16, 32))


class _FakeEngine:
    """A MagpieEngine stand-in whose frames are fixed codes (the stream's
    codec window is what is counted here)."""

    def __init__(self, codes, max_steps):
        from magpie_tts_tpu_torch.config import MagpieConfig

        self.config = MagpieConfig(max_dec_steps=max_steps)
        self.codes = codes

    def begin_stream(self, token_ids, speaker_id=0):
        from types import SimpleNamespace

        state = SimpleNamespace(frame_idx=0, codes=np.zeros_like(self.codes))
        return {"state": state}

    def decode_chunk(self, stream, *, n_frames, **_):
        s = stream["state"]
        end = min(s.frame_idx + n_frames, len(self.codes))
        s.codes[s.frame_idx:end] = self.codes[s.frame_idx:end]
        start, s.frame_idx = s.frame_idx, end
        return s.codes[start:end], end >= len(self.codes)


@pytest.mark.parametrize("path", ["decode", "decode_batch", "stream"])
def test_switch_reaches_the_wrapper_on_every_codec_path(monkeypatch, path):
    """MAGPIE_FUSED_CODEC routes every res layer of <= 128 channels (here all
    5 stages) through res_layer_fused, on the stacked layers the engine
    keeps, and no res-block conv through the per-conv wrapper."""
    calls = {"fused": 0, "conv": 0, "stacked": 0}
    fused, conv, stack = tcodec.res_layer_fused, tcodec.snake_causal_conv, crf.stack_res_layer

    def count(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(tcodec, "res_layer_fused", count("fused", fused))
    monkeypatch.setattr(tcodec, "snake_causal_conv", count("conv", conv))
    monkeypatch.setattr(tcodec, "stack_res_layer", count("stacked", stack))
    monkeypatch.setenv("MAGPIE_FUSED_CODEC", "1")
    eng = _tiny_engine()
    codes = np.random.default_rng(1).integers(0, 16, size=(10, 8)).astype(np.int32)
    if path == "decode":
        eng.decode(codes)
        eng.decode(codes)
        n_decodes = 2
    elif path == "decode_batch":
        eng.decode_batch([codes, codes[:7], codes[:3]])
        n_decodes = 1
    else:
        chunks = list(stream_sentence(_FakeEngine(codes, 16), eng, [1, 2],
                                      StreamParams(frames_per_chunk=4)))
        n_decodes = len(chunks)
        assert n_decodes == 3
    assert calls == {"fused": 5 * n_decodes, "conv": 2 * n_decodes, "stacked": 5}
