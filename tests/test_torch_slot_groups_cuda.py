"""Slot groups on the card: kernels C, 7 and 8 past one launch's
``frame_step_batched.MAX_SLOTS`` = 64 slots, run as groups of at most 64
(one launch each). At B = 65 against their plain versions (float32 codes
exact and floats within TOL; bf16 codes exact and floats within the bf16
bar, 95% within 1 scaled ulp, none past 8); at B = 96 and 128 every slot's
codes, hidden row and new K/V rows bit-equal to the same slots run as
launches of at most 64 that cut the batch elsewhere. Marked ``cuda``: they
skip without a card. This module imports no JAX; run it on the card with
``MAGPIE_TEST_TPU=1 python -m pytest tests/test_torch_slot_groups_cuda.py -q
-m cuda``."""

import pytest
import torch

from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu_torch.models import magpie as magpie_mod
from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
from magpie_tts_tpu_torch.runtime import engine as engine_mod
from tests.test_torch_cuda import SMALL, TOL, _batched_inputs, _bf16_close

pytestmark = pytest.mark.cuda

BF = torch.bfloat16
WRITE_ROW = 30
CUT = 48   # the comparison's launches: slots [a, a + 48), off the group edges


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return engine_mod.resolve_device("cuda")


def _inputs(cuda, B, dtype):
    """B slots of ring masks (tests/test_torch_cuda.py's), with the empty
    slot moved from the last group to slot B // 2 - 1."""
    w = random_magpie_weights(SMALL, seed=11).to(device=cuda, dtype=dtype)
    x = _batched_inputs(w, B, WRITE_ROW, cuda)
    x["valid"] = x["valid"].roll(B // 2, 0).contiguous()
    for key in ("hidden", "xa_k", "xa_v", "k_cache", "v_cache"):
        x[key] = x[key].to(dtype)
    return w, x


def _eos(sampled, argmax):
    return ((sampled == SMALL.audio_eos_id) | (argmax == SMALL.audio_eos_id)).any(-1)


def _step8(w, x, sampled, argmax):
    """Kernel 8's inputs after a frame's codes, as kernel C builds them."""
    valid = x["valid"].clone()
    valid[:, WRITE_ROW] = x["may_continue"] & ~_eos(sampled, argmax)
    return (magpie_mod.audio_frame_embedding(sampled, w, SMALL) + x["posemb"], WRITE_ROW, valid,
            x["xa_k"], x["xa_v"])


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
def test_past_one_launch_matches_plain(cuda, dtype, temperature):
    """B = 65: kernels C, 7 and 8 launch twice each (64 + 1 slots) and
    agree with their plain versions at the bars of B <= 64."""
    B = 65
    w, x = _inputs(cuda, B, dtype)
    (kk, vk), (kr, vr), (k8, v8), (k8r, v8r) = [(x["k_cache"].clone(), x["v_cache"].clone())
                                                for _ in range(4)]
    args = {k: v for k, v in x.items() if k not in ("k_cache", "v_cache")}
    args.update(weights=w, config=SMALL, temperature=temperature, top_k=8)
    for m in (fsb, ltsb, dsb):
        m.launches = 0
        m.dtype_launches = dict.fromkeys(m.dtype_launches, 0)
    with torch.no_grad():
        sk, ak, hk, _, _ = fsb.frame_step_batched(k_cache=kk, v_cache=vk, **args)
        sr, ar, hr, _, _ = fsb.frame_step_batched_reference(k_cache=kr, v_cache=vr, **args)
        s7, a7 = ltsb.sample_frame_codes_batched(x["hidden"], w, SMALL, x["seeds"], temperature,
                                                 8, x["forbid_eos"])
        step = _step8(w, x, sr, ar)
        h8 = dsb.decode_step_batched(*step, k8, v8, w, SMALL, x["enc_lengths"])
        h8r = dsb.decode_step_batched_reference(*step, k8r, v8r, w, SMALL, x["enc_lengths"])
    torch.cuda.synchronize()
    name = "float32" if dtype == torch.float32 else "bfloat16"
    for m in (fsb, ltsb, dsb):
        assert m.launches == 2 and m.dtype_launches[name] == 2
    assert torch.equal(sk, sr) and torch.equal(ak, ar)
    assert torch.equal(s7, sr) and torch.equal(a7, ar)
    live = x["valid"].any(-1).nonzero().flatten()
    assert B - 1 in live.tolist()
    r = WRITE_ROW
    pairs_c = ((hk[live], hr[live]), (kk[live][:, :, r], kr[live][:, :, r]),
               (vk[live][:, :, r], vr[live][:, :, r]))
    pairs_8 = ((h8[live], h8r[live]), (k8[live][:, :, r], k8r[live][:, :, r]),
               (v8[live][:, :, r], v8r[live][:, :, r]))
    if dtype == torch.float32:
        for got, want in pairs_c + pairs_8:
            assert float((got - want).abs().max()) < TOL
    else:
        _bf16_close(pairs_c)
        _bf16_close(pairs_8)
    assert torch.isfinite(hk).all() and torch.isfinite(h8).all()


@pytest.mark.parametrize("B", [96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
def test_slots_bit_equal_to_launches_of_at_most_64(cuda, dtype, B):
    """B = 96 (64 + 32) and 128 (64 + 64) against the same slots in launches
    of 48: codes, hidden rows and the new K/V rows bit for bit, kernels C, 7
    and 8."""
    w, x = _inputs(cuda, B, dtype)
    cuts = [slice(a, min(a + CUT, B)) for a in range(0, B, CUT)]
    (kg, vg), (ks, vs), (k8g, v8g), (k8s, v8s) = [(x["k_cache"].clone(), x["v_cache"].clone())
                                                  for _ in range(4)]
    args = {k: v for k, v in x.items() if k not in ("k_cache", "v_cache")}
    common = dict(weights=w, config=SMALL, temperature=0.7, top_k=8)
    fsb.launches = 0
    with torch.no_grad():
        whole = fsb.frame_step_batched(k_cache=kg, v_cache=vg, **args, **common)[:3]
        whole += ltsb.sample_frame_codes_batched(x["hidden"], w, SMALL, x["seeds"], 0.7, 8,
                                                 x["forbid_eos"])
        step = _step8(w, x, whole[0], whole[1])
        whole += (dsb.decode_step_batched(*step, k8g, v8g, w, SMALL, x["enc_lengths"]),)
        assert fsb.launches == len(fsb.slot_groups(B)) == 2
        parts = []
        for sl in cuts:
            a = {k: v[sl] if isinstance(v, torch.Tensor) else v for k, v in args.items()}
            got = fsb.frame_step_batched(k_cache=ks[sl], v_cache=vs[sl], **a, **common)[:3]
            got += ltsb.sample_frame_codes_batched(a["hidden"], w, SMALL, a["seeds"], 0.7, 8,
                                                   a["forbid_eos"])
            got += (dsb.decode_step_batched(step[0][sl], WRITE_ROW, step[2][sl], step[3][sl],
                                            step[4][sl], k8s[sl], v8s[sl], w, SMALL,
                                            a["enc_lengths"]),)
            parts.append(got)
    torch.cuda.synchronize()
    for i, got in enumerate(whole):
        assert torch.equal(_bits(got), _bits(torch.cat([p[i] for p in parts]))), i
    for p, q in ((kg, ks), (vg, vs), (k8g, k8s), (v8g, v8s)):
        assert torch.equal(_bits(p), _bits(q))


def test_no_slot_refused(cuda):
    """B = 0 still raises; a lone launch of 65 slots is refused before the
    library is called."""
    w, x = _inputs(cuda, 3, torch.float32)
    with pytest.raises(ValueError, match="at least 1"):
        ltsb.sample_frame_codes_batched(x["hidden"][:0], w, SMALL, x["seeds"][:0], 0.7, 8,
                                        x["forbid_eos"][:0])
    with pytest.raises(ValueError, match="a launch takes 1..64"):
        fsb.launch("magpie_lt_sample_batched_f32", 65, {}, {}, SMALL, cuda)
