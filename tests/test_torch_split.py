"""PyTorch port, the split decode path (``--no-fused``, ``MAGPIE_NO_FUSED``):
the plain versions of the LT sampler and decoder step kernels, single-stream
and batched, against the Pallas TPU kernels they replace in interpret mode
(as tests/test_pallas_kernels.py runs them), or against the JAX XLA path
where the TPU kernel refuses the slot count; then the three split loops
(single stream, lockstep, continuous) end to end against the JAX package, and
the CLI flag and environment switch, on the CPU. The CUDA kernels themselves
are tested on the card by tests/test_torch_cuda.py."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magpie_tts_tpu.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu.models import decoder as jdecoder
from magpie_tts_tpu.models import local_transformer as jlt
from magpie_tts_tpu.models import magpie as jmagpie
from magpie_tts_tpu.ops import sampling as jsampling
from magpie_tts_tpu.ops.pallas_kernels.decoder_step import decode_step_pallas
from magpie_tts_tpu.ops.pallas_kernels.decoder_step_batched import decode_step_batched_pallas
from magpie_tts_tpu.ops.pallas_kernels.lt_sampler import sample_frame_codes_pallas
from magpie_tts_tpu.ops.pallas_kernels.lt_sampler_batched import (
    batched_shapes_ok, sample_frame_codes_batched_pallas)
from magpie_tts_tpu.parallel.continuous import ContinuousBatchingEngine as JaxContinuous
from magpie_tts_tpu.parallel.serving import BatchedMagpieEngine as JaxBatchedEngine
from magpie_tts_tpu_torch import cli
from magpie_tts_tpu_torch.io.wav import read_wav
from magpie_tts_tpu_torch.models import magpie as tmagpie
from magpie_tts_tpu_torch.ops import sampling as ts
from magpie_tts_tpu_torch.ops.kernels import decoder_step as ds
from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
from magpie_tts_tpu_torch.ops.kernels import frame_step as fs
from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
from magpie_tts_tpu_torch.ops.kernels import lt_sampler as lts
from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
from magpie_tts_tpu_torch.parallel import continuous as tcontinuous
from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine
from magpie_tts_tpu_torch.parallel.serving import BatchedMagpieEngine
from magpie_tts_tpu_torch.pipeline import MagpiePipeline
from magpie_tts_tpu_torch.runtime.engine import MagpieEngine
from tests import fixtures
from tests.test_torch_support import port_magpie_weights, t
from tests.utils import tiny_magpie_config

CONFIG = tiny_magpie_config()
TOL = 4e-6    # the JAX package's own float tolerance between its decode kernels
TOP_K = 8
ENC = 16      # cross-attention rows of the batched inputs


@pytest.fixture(scope="module")
def weights():
    jw = random_magpie_weights(CONFIG, seed=11)
    return jw, port_magpie_weights(jw)


def _tokens(rng, n):
    return [CONFIG.text_bos_id] + [int(v) for v in rng.integers(2, 30, size=n)] + \
        [CONFIG.text_eos_id]


# ------------------------------------------------------- kernel 4: LT sampler

# 2 interpret calls per case, each with its own hidden state and seed.
@pytest.mark.parametrize("temperature,forbid", [(0.0, False), (0.0, True), (0.7, False),
                                                (0.7, True)])
def test_lt_sampler_reference_matches_pallas_interpret(weights, temperature, forbid):
    jw, pw = weights
    rng = np.random.default_rng(int(temperature * 10) + 2 * forbid)
    for _ in range(2):
        hidden = rng.normal(0, 0.5, CONFIG.d_model).astype(np.float32)
        seed = int(rng.integers(-2**31, 2**31))
        s_j, a_j = sample_frame_codes_pallas(
            jnp.asarray(hidden), jw, CONFIG, jnp.int32(seed), jnp.float32(temperature), TOP_K,
            jnp.bool_(forbid), interpret=True)
        with torch.no_grad():
            s_p, a_p = lts.sample_frame_codes(t(hidden), pw, CONFIG, seed, temperature, TOP_K,
                                              forbid)
        np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))


# ---------------------------------------------------- kernel 5: decoder step

def _caches(rng, *lead):
    L, S, D = CONFIG.dec_layers, CONFIG.max_seq, CONFIG.d_model
    return (rng.normal(0, 0.5, (*lead, L, S, D)).astype(np.float32),
            rng.normal(0, 0.5, (*lead, L, S, D)).astype(np.float32))


def _xa(rng, *lead):
    L, X = CONFIG.dec_layers, CONFIG.d_xa
    return (rng.normal(0, 0.5, (*lead, L, ENC, X)).astype(np.float32),
            rng.normal(0, 0.5, (*lead, L, ENC, X)).astype(np.float32))


@pytest.mark.parametrize("pos,enc_len", [(CONFIG.context_frames + 1, 6), (40, 16)])
def test_decode_step_reference_matches_pallas_interpret(weights, pos, enc_len):
    """Position embedding added inside; row ``pos`` of every layer written in
    place, every other row untouched."""
    jw, pw = weights
    rng = np.random.default_rng(pos)
    x = rng.normal(0, 0.1, CONFIG.d_model).astype(np.float32)
    k, v = _caches(rng)
    xa_k, xa_v = _xa(rng)
    h_j, k_j, v_j = decode_step_pallas(
        jnp.asarray(x), jnp.int32(pos), jnp.asarray(xa_k), jnp.asarray(xa_v), jnp.asarray(k),
        jnp.asarray(v), jw, CONFIG, enc_length=jnp.int32(enc_len), interpret=True)
    k_p, v_p = t(k), t(v)
    with torch.no_grad():
        h_p = ds.decode_step(t(x), pos, t(xa_k), t(xa_v), k_p, v_p, pw, CONFIG,
                             enc_length=enc_len)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), atol=TOL, rtol=0)
    for got, want, before in ((k_p, k_j, k), (v_p, v_j, v)):
        np.testing.assert_allclose(got.numpy()[:, pos], np.asarray(want)[:, pos], atol=TOL,
                                   rtol=0)
        keep = np.arange(CONFIG.max_seq) != pos
        np.testing.assert_array_equal(got.numpy()[:, keep], before[:, keep])


# ------------------------------------------------ kernel 7: batched LT sampler

def _sampler_inputs(rng, B):
    return (rng.normal(0, 0.5, (B, CONFIG.d_model)).astype(np.float32),
            rng.integers(-2**31, 2**31, B).astype(np.int32), rng.random(B) < 0.4)


def _port_sample_batched(pw, hidden, seeds, forbid, temperature):
    with torch.no_grad():
        s, a = ltsb.sample_frame_codes_batched(t(hidden), pw, CONFIG, t(seeds), temperature,
                                               TOP_K, t(forbid))
    return s.numpy(), a.numpy()


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_lt_sampler_batched_reference_matches_pallas_interpret(weights, temperature):
    """B = 8, per-slot seeds and EOS flags."""
    jw, pw = weights
    hidden, seeds, forbid = _sampler_inputs(np.random.default_rng(8), 8)
    s_j, a_j = sample_frame_codes_batched_pallas(
        jnp.asarray(hidden), jw, CONFIG, jnp.asarray(seeds), jnp.float32(temperature), TOP_K,
        jnp.asarray(forbid), interpret=True)
    s_p, a_p = _port_sample_batched(pw, hidden, seeds, forbid, temperature)
    np.testing.assert_array_equal(s_p, np.asarray(s_j))
    np.testing.assert_array_equal(a_p, np.asarray(a_j))


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_lt_sampler_batched_reference_matches_jax_at_b3(weights, temperature):
    """B = 3, which the TPU kernel's layout refuses (``batched_shapes_ok``):
    against JAX's vmap of the XLA sampler, whose key (0, seed) gives the
    slot's seed."""
    jw, pw = weights
    hidden, seeds, forbid = _sampler_inputs(np.random.default_rng(3), 3)
    assert not batched_shapes_ok(3)
    mask = jsampling.forbidden_token_mask(CONFIG.vocab_per_cb, CONFIG.audio_bos_id,
                                          CONFIG.audio_eos_id)
    keys = jnp.stack([jnp.zeros(3, jnp.uint32), jnp.asarray(seeds.view(np.uint32))], axis=1)
    s_j, a_j = jax.vmap(lambda h, k, f: jlt.sample_frame_codes(
        h, jw, CONFIG, k, jnp.float32(temperature), TOP_K, f, mask))(
        jnp.asarray(hidden), keys, jnp.asarray(forbid))
    s_p, a_p = _port_sample_batched(pw, hidden, seeds, forbid, temperature)
    np.testing.assert_array_equal(s_p, np.asarray(s_j))
    np.testing.assert_array_equal(a_p, np.asarray(a_j))


# -------------------------------------------- kernel 8: batched decoder step

WRITE_ROW = 3   # just past the ring's wrap: runs end at max_seq - 1 and restart at 0


def _ring_valid(B):
    """Ring-style masks that hold the write row for live slots: runs of
    different lengths ending at WRITE_ROW, most wrapping past max_seq - 1;
    the last slot empty (never admitted)."""
    S = CONFIG.max_seq
    valid = np.zeros((B, S), bool)
    for b in range(B - 1):
        valid[b, (WRITE_ROW - np.arange(4 + 3 * b % 40)) % S] = True
    assert valid[:-1, WRITE_ROW].all() and valid[:, S - 1].any()
    return valid


def _decoder_inputs(rng, B):
    k, v = _caches(rng, B)
    xa_k, xa_v = _xa(rng, B)
    return dict(x=rng.normal(0, 0.1, (B, CONFIG.d_model)).astype(np.float32),
                lp=rng.integers(CONFIG.context_frames + 1, CONFIG.max_pos, B),
                valid=_ring_valid(B), k=k, v=v, xa_k=xa_k, xa_v=xa_v,
                enc=rng.integers(1, ENC + 1, B).astype(np.int32))


def _port_decode_batched(pw, d):
    x_pe = d["x"] + pw.decoder.pos_emb.numpy()[d["lp"]]
    k_p, v_p = t(d["k"]), t(d["v"])
    with torch.no_grad():
        h = dsb.decode_step_batched(t(x_pe), WRITE_ROW, t(d["valid"]), t(d["xa_k"]),
                                    t(d["xa_v"]), k_p, v_p, pw, CONFIG, t(d["enc"]))
    return x_pe, h.numpy(), k_p.numpy(), v_p.numpy()


def test_decode_step_batched_reference_matches_pallas_interpret(weights):
    """B = 8: live slots to TOL; the empty slot finite (its uniform attention
    window is the TPU kernel's own)."""
    jw, pw = weights
    d = _decoder_inputs(np.random.default_rng(18), 8)
    x_pe, h_p, k_p, v_p = _port_decode_batched(pw, d)
    h_j, k_j, v_j = decode_step_batched_pallas(
        jnp.asarray(x_pe), jnp.int32(WRITE_ROW), jnp.asarray(d["valid"]), jnp.asarray(d["xa_k"]),
        jnp.asarray(d["xa_v"]), jnp.asarray(d["k"]), jnp.asarray(d["v"]), jw, CONFIG,
        jnp.asarray(d["enc"]), interpret=True)
    live = slice(0, 7)
    for got, want in ((h_p, h_j), (k_p, k_j), (v_p, v_j)):
        np.testing.assert_allclose(got[live], np.asarray(want)[live], atol=TOL, rtol=0)
        assert np.isfinite(got).all()


def test_decode_step_batched_reference_matches_jax_at_b13(weights):
    """B = 13 (the TPU kernel asserts B % 8 == 0 above 8): against JAX's vmap
    of the XLA ``decode_step_masked`` with each slot's logical position."""
    jw, pw = weights
    d = _decoder_inputs(np.random.default_rng(13), 13)
    _, h_p, k_p, v_p = _port_decode_batched(pw, d)
    h_j, k_j, v_j = jax.vmap(lambda x, lp, vm, xk, xv, kc, vc, el: jdecoder.decode_step_masked(
        x, lp, jnp.int32(WRITE_ROW), vm, xk, xv, kc, vc, jw, CONFIG, enc_length=el))(
        *(jnp.asarray(d[n]) for n in ("x", "lp", "valid", "xa_k", "xa_v", "k", "v", "enc")))
    live = slice(0, 12)
    for got, want in ((h_p, h_j), (k_p, k_j), (v_p, v_j)):
        np.testing.assert_allclose(got[live], np.asarray(want)[live], atol=TOL, rtol=0)


# ------------------------------------------------------- the loops end to end

@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_synthesize_codes_split_equals_jax(weights, temperature):
    """``synthesize_codes_program(use_fused=False)`` against the JAX program
    (its XLA path on the CPU): the same codes and frame count, which also
    equal the port's fused path."""
    jw, pw = weights
    tokens = np.random.default_rng(6).integers(2, CONFIG.text_vocab_size - 2, size=16)
    codes_j, n_j = jmagpie.synthesize_codes_program(
        jnp.asarray(tokens, jnp.int32), jnp.int32(9), jnp.int32(1), jax.random.PRNGKey(4),
        jnp.float32(temperature), jw, CONFIG, TOP_K)
    runs = [tmagpie.synthesize_codes_program(torch.from_numpy(tokens), 9, 1, ts.prng_key(4),
                                             temperature, pw, CONFIG, TOP_K, use_fused=fused)
            for fused in (False, True)]
    n = int(n_j)
    for codes, n_frames in runs:
        assert n_frames == n
        np.testing.assert_array_equal(codes[:n], np.asarray(codes_j)[:n])


@pytest.fixture(scope="module")
def lockstep(weights):
    jw, pw = weights
    buckets = (16, 32)
    return (JaxBatchedEngine(jw, CONFIG, batch_size=4, token_buckets=buckets),
            BatchedMagpieEngine(pw, CONFIG, batch_size=4, device="cpu", token_buckets=buckets,
                                use_fused=False))


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_lockstep_split_codes_equal_jax(lockstep, temperature):
    """Three requests padded to B = 4 through the split lockstep loop."""
    jeng, teng = lockstep
    rng = np.random.default_rng(3)
    reqs = [_tokens(rng, n) for n in (4, 9, 12)]
    want = jeng.synthesize_batch(reqs, temperature=temperature, top_k=TOP_K, seed=5,
                                 speaker_ids=[0, 1, 0])
    got = teng.synthesize_batch(reqs, temperature=temperature, top_k=TOP_K, seed=5,
                                speaker_ids=[0, 1, 0])
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _drive(engine, waves, temperature):
    """Submit wave 0, then one wave per step, then pump until drained."""
    ids = [engine.submit(tok, seed=seed) for tok, seed in waves[0]]
    finished = dict(engine.step(temperature=temperature, top_k=TOP_K))
    for wave in waves[1:]:
        ids += [engine.submit(tok, seed=seed) for tok, seed in wave]
        finished.update(engine.step(temperature=temperature, top_k=TOP_K))
    while engine.pending:
        finished.update(engine.step(temperature=temperature, top_k=TOP_K))
    assert sorted(finished) == sorted(ids)
    return [finished[i] for i in ids]


# (slots, segment_frames, token buckets, request lengths per wave, temperature)
CONTINUOUS_CASES = {
    # requests join after a segment advanced the ring pointer; 3 slots
    "staggered": (3, 5, (16, 32), [[4, 9, 6], [12, 5]], 0.7),
    # one slot reused; 16-frame segments wrap the 48-row ring
    "slot_reuse": (1, 16, (16,), [[5], [8], [3]], 0.0),
}


@pytest.mark.parametrize("case", sorted(CONTINUOUS_CASES))
def test_continuous_split_codes_equal_jax(weights, case):
    jw, pw = weights
    slots, seg, buckets, lengths, temperature = CONTINUOUS_CASES[case]
    rng = np.random.default_rng(len(case))
    waves = [[(_tokens(rng, n), 3 + i) for i, n in enumerate(wave)] for wave in lengths]
    want = _drive(JaxContinuous(jw, CONFIG, n_slots=slots, token_buckets=buckets,
                                segment_frames=seg), waves, temperature)
    engine = ContinuousBatchingEngine(pw, CONFIG, n_slots=slots, device="cpu",
                                      token_buckets=buckets, segment_frames=seg,
                                      use_fused=False)
    got = _drive(engine, waves, temperature)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{case} request {i}")


# ------------------------------------------------------ CLI and environment

@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_split")
    mpath, cpath = str(tmp / "magpie.gguf"), str(tmp / "codec.gguf")
    fixtures.write_tiny_magpie_gguf(mpath, seed=0)
    fixtures.write_tiny_codec_gguf(cpath, seed=1)
    return mpath, cpath


class _Calls:
    """Counts the calls of the loops' kernel entry points; the fused ones
    must not be reached."""

    SPLIT = ("sample_frame_codes", "decode_step", "sample_frame_codes_batched",
             "decode_step_batched")
    FUSED = ("frame_step", "frame_step_batched")

    def __init__(self, monkeypatch):
        self.n = {}
        for module in (tmagpie, tcontinuous):
            for name in self.SPLIT + self.FUSED:
                if hasattr(module, name):
                    monkeypatch.setattr(module, name, self._wrap(module, name))

    def _wrap(self, module, name):
        fn = getattr(module, name)

        def counted(*a, **k):
            if name in self.FUSED:
                raise AssertionError(f"{module.__name__}.{name} reached on the split path")
            self.n[name] = self.n.get(name, 0) + 1
            return fn(*a, **k)
        return counted


def test_cli_no_fused_writes_wav(paths, monkeypatch, tmp_path, capsys):
    """``--no-fused --device cpu``: the split loop runs (one sampler and one
    decoder step per frame, no fused frame) and the WAV holds the codes of
    the fused path."""
    calls = _Calls(monkeypatch)
    out = str(tmp_path / "split.wav")
    rc = cli.main(["-m", paths[0], "-c", paths[1], "-t", "hello world", "-o", out,
                   "--device", "cpu", "--temp", "0.7", "--seed", "3", "--no-fused", "-q"])
    assert rc == 0 and capsys.readouterr().out.strip() == out
    samples, sr = read_wav(out)
    pipe = MagpiePipeline.from_gguf(*paths, device="cpu", use_fused=True)
    monkeypatch.undo()
    codes = pipe.synthesize_codes("hello world", temperature=0.7, seed=3)
    assert sr == 22050 and len(samples) == codes.shape[0] * pipe.codec.config.hop_length
    n_steps = codes.shape[0] + (codes.shape[0] < pipe.config.max_dec_steps)
    assert calls.n == {"sample_frame_codes": n_steps, "decode_step": n_steps}
    pcm = pipe.codec.decode(codes, pcm16=True)
    np.testing.assert_array_equal(samples, pcm.astype(np.float32) / 32767.0)


def test_cli_no_fused_without_cuda_exits_1(paths, tmp_path, monkeypatch, capsys):
    """The flag is ported (no longer rejected) and has no CPU fallback."""
    assert "--no-fused" not in cli._NOT_PORTED_FLAGS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.wav"
    rc = cli.main(["-m", paths[0], "-c", paths[1], "-t", "hello", "-o", str(out), "--no-fused"])
    assert rc == 1 and not out.exists()
    assert "no CUDA device" in capsys.readouterr().err


def test_env_switch_reaches_every_split_branch(weights, paths, monkeypatch, tmp_path):
    """MAGPIE_NO_FUSED=1 sends the single-stream engine, the lockstep engine
    and ``serve``'s continuous engine through the split kernels' wrappers."""
    _, pw = weights
    monkeypatch.setenv("MAGPIE_NO_FUSED", "1")
    calls = _Calls(monkeypatch)
    rng = np.random.default_rng(9)
    MagpieEngine(pw, CONFIG, device="cpu", token_buckets=(16,)).synthesize_codes(
        _tokens(rng, 5), temperature=0.7, top_k=TOP_K)
    assert set(calls.n) == {"sample_frame_codes", "decode_step"}
    BatchedMagpieEngine(pw, CONFIG, batch_size=2, device="cpu", token_buckets=(16,)) \
        .synthesize_batch([_tokens(rng, 4), _tokens(rng, 6)], temperature=0.7, top_k=TOP_K)
    lockstep = calls.n["sample_frame_codes_batched"]
    assert lockstep > 0 and calls.n["decode_step_batched"] == lockstep
    monkeypatch.setattr("sys.stdin", io.StringIO('{"id": "a", "text": "hello world"}\n'))
    rc = cli.main(["serve", "-m", paths[0], "-c", paths[1], "--out-dir", str(tmp_path),
                   "--slots", "3", "--segment-frames", "4", "--device", "cpu", "-q"])
    assert rc == 0 and (tmp_path / "a.wav").exists()
    served = calls.n["sample_frame_codes_batched"] - lockstep
    assert served > 0 and served % 4 == 0
    assert calls.n["decode_step_batched"] == calls.n["sample_frame_codes_batched"]


def test_split_wrappers_count_no_cpu_launch(weights):
    """On CPU tensors the four wrappers run their plain versions: no kernel
    launch is counted, so a main-path count can only come from the card."""
    _, pw = weights
    for module in (lts, ds, ltsb, dsb, fs, fsb):
        module.launches = 0
    rng = np.random.default_rng(1)
    hidden, seeds, forbid = _sampler_inputs(rng, 2)
    d = _decoder_inputs(rng, 8)
    with torch.no_grad():
        lts.sample_frame_codes(t(hidden[0]), pw, CONFIG, 1, 0.7, TOP_K, False)
        ds.decode_step(t(d["x"][0]), 9, t(d["xa_k"][0]), t(d["xa_v"][0]), t(d["k"][0]),
                       t(d["v"][0]), pw, CONFIG)
        _port_sample_batched(pw, hidden, seeds, forbid, 0.7)
        _port_decode_batched(pw, d)
    assert all(m.launches == 0 for m in (lts, ds, ltsb, dsb, fs, fsb))

