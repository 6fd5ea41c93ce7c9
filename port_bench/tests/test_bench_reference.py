"""The plain reference against the port at a tiny size on the CPU: the same
weights and inputs, float32 on both sides."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from port_bench import check, port, run, spec, weights
from port_bench.reference import sampling
from port_bench.reference.codec import Codec
from port_bench.reference.model import Magpie

from . import tiny


@pytest.fixture(scope="module")
def ctx():
    wl = {**spec.load("workloads", "stream-f32"), **tiny.overrides("stream-f32")["workload"]}
    cfg = {**spec.load("configs", "magpie357m-f32"), **tiny.overrides("stream-f32")["config"]}
    return run.build_context("stream-f32", wl, cfg, 3, "cpu")


def test_sampling_rule_matches_the_port():
    from magpie_tts_tpu_torch.ops import sampling as port_sampling

    key = sampling.request_key(123456, 77)
    assert tuple(int(k) for k in key) == port_sampling.fold_in(port_sampling.prng_key(123456), 77)
    ours = sampling.frame_seeds(key[None], 9)[0].tolist()
    assert ours == port_sampling.frame_seeds(tuple(int(k) for k in key), 9)
    noise = sampling.gumbel(torch.tensor([ours[3]]), 8, 2024)[0]
    for cb in (0, 5):
        want = port_sampling.gumbel_from_seed(port_sampling.phase_seed(ours[3], cb),
                                              torch.arange(2024))
        torch.testing.assert_close(noise[cb].float(), want, rtol=1e-6, atol=1e-6)


def test_weights_fill_the_port_containers(ctx):
    assert ctx.magpie_weights.decoder.qkv.data_ptr() == ctx.raw_magpie["decoder.qkv"].data_ptr()
    for key, t in {**ctx.raw_magpie, **ctx.raw_codec}.items():
        assert t.storage_offset() * t.element_size() % 256 == 0, key
    again = weights.make(weights.codec_shapes(ctx.chp), weights.sub_seed(3, "codec"), "cpu",
                         torch.float32)
    for key in ctx.raw_codec:
        assert torch.equal(again[key], ctx.raw_codec[key])
    assert float(ctx.raw_magpie["decoder.norm_ff"].mean()) == pytest.approx(1.0, abs=0.02)
    alphas = ctx.raw_codec["post_alpha"]
    assert 0.6 <= float(alphas.min()) and float(alphas.max()) <= 1.5


def test_reference_logits_match_the_port_served_codes(ctx):
    """Codes the port samples on the CPU at temperature 0.7 (the stream
    path's key chain) lie at gap ~0 under the reference's logits."""
    from magpie_tts_tpu_torch.runtime.engine import MagpieEngine

    engine = MagpieEngine(ctx.magpie_weights, ctx.mcfg, device="cpu")
    tokens = [ctx.mcfg.text_bos_id] + list(range(5, 25)) + [ctx.mcfg.text_eos_id]
    stream = engine.begin_stream(tokens, speaker_id=2)
    codes, done = [], False
    while not done:
        new, done = engine.decode_chunk(stream, n_frames=4, seed=99)
        codes.append(new)
    codes = np.concatenate(codes)
    n, cap = len(codes), ctx.mcfg.max_dec_steps
    end = stream["state"].codes[n].copy() if n < cap else None   # the EOS frame's codes
    seeds = np.concatenate([sampling.frame_seeds(sampling.request_key(99, i)[None], 4)[0]
                            for i in range(n // 4 + 1)])[:n + 1]
    hp = dataclasses.asdict(ctx.mcfg)
    judge = Magpie(ctx.raw_magpie, hp, "cpu")
    gap, ends = check.token_readings([check.Served(tuple(tokens), 2, codes, seeds, end=end)],
                                     judge, hp, 0.7, 80)
    assert n >= 6 and gap[0] < 1e-4
    assert (ends[0] < 1e-4) if n < cap else np.isnan(ends[0])
    altered = codes.copy()
    altered[2, 3] = (altered[2, 3] + 1) % 2016
    bad, _ = check.token_readings([check.Served(tuple(tokens), 2, altered, seeds, end=end)],
                                  judge, hp, 0.7, 80)
    assert bad[0] > 1e-2
    # Ended two frames early, on a frame the rule goes on from.
    early, early_end = check.token_readings(
        [check.Served(tuple(tokens), 2, codes[:n - 2], seeds[:n - 1], end=codes[n - 2])],
        judge, hp, 0.7, 80)
    assert early[0] == early_end[0] > 1e-3
    # Ended short of the cap with no EOS frame reported.
    lost, _ = check.token_readings([check.Served(tuple(tokens), 2, codes[:n - 2], seeds[:n - 1])],
                                   judge, hp, 0.7, 80)
    assert np.isinf(lost[0])


def test_reference_codec_matches_the_port(ctx):
    from magpie_tts_tpu_torch.runtime.engine import CodecEngine

    codes = np.random.default_rng(0).integers(0, 2016, size=(13, 8)).astype(np.int32)
    audio = CodecEngine(ctx.codec_weights, ctx.ccfg, device="cpu").decode(codes)
    judge = Codec(ctx.raw_codec, dataclasses.asdict(ctx.ccfg), "cpu")
    sound = check.codec_reading(codes, audio, judge, ctx.ccfg.hop_length)
    assert sound["frame_err"] < 1e-5 and sound["rel_rms"] < 1e-5 and sound["frame_flips"] == 0
    audio[5 * 16:6 * 16] = 0.0
    assert check.codec_reading(codes, audio, judge, ctx.ccfg.hop_length)["frame_err"] > 0.1


def test_port_weight_containers_keep_every_field(ctx):
    flat = {k: v for k, v in ctx.magpie_weights.flatten().items()}
    assert set(flat) == set(ctx.raw_magpie)
    assert set(ctx.codec_weights.flatten()) == set(ctx.raw_codec)
    assert isinstance(ctx.magpie_weights, port.MagpieWeights)


def _witness(m, g, s, eps, k, T):
    """Logits within +-eps of m under which the rule picks s (as the bound's
    proof builds them): s up, threats down, harmless codes between the
    highest threat and s."""
    ms, gs = float(m[s]), float(g[s])
    beat = m - ms + T * (g - gs)
    threat = beat > 2 * eps
    threat[s] = False
    top_threat = float((m - eps)[threat].max()) if bool(threat.any()) else -1e9
    ps = ms + eps
    p = m.clone()
    for j in range(m.shape[0]):
        if j == s:
            p[j] = ps
        elif threat[j]:
            p[j] = m[j] - eps
        else:
            low = float(m[j] - eps)
            top = min(float(m[j] + eps), ps + T * (gs - float(g[j])) - 1e-12, ps - 1e-12)
            p[j] = low if low > ps or top <= top_threat else top
    kth = p.topk(k).values[-1]
    return int(torch.where(p >= kth, p / T + g, torch.full_like(p, -torch.inf)).argmax())


def test_min_perturbation_is_feasible_and_least():
    k, T = 7, 0.7
    for trial in range(6):
        gen = torch.Generator().manual_seed(trial)
        m = torch.randn(1, 60, generator=gen, dtype=torch.float64) * 0.1
        g = -torch.log(-torch.log(torch.rand(1, 60, generator=gen, dtype=torch.float64)))
        for s in range(60):
            eps = float(sampling.min_perturbation(m, g, torch.tensor([s]), T, k))
            assert _witness(m[0], g[0], s, eps * (1 + 1e-6) + 1e-12, k, T) == s
            if eps > 1e-6:
                assert _witness(m[0], g[0], s, eps * 0.98, k, T) != s
