"""PyTorch port, slot groups: kernels C, 7 and 8 run any B >= 1 slots as
groups of at most ``frame_step_batched.MAX_SLOTS`` (one launch each on the
card, one plain call each on the CPU). Here the group size is lowered to 4,
so that groups run on the CPU: the group rule, each wrapper's grouped call
against one ungrouped plain call, and the continuous and lockstep engines at
9 slots against the JAX engines (exact codes at temp 0 and 0.7). The card's
side is tests/test_torch_slot_groups_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

from magpie_tts_tpu.io.magpie_weights import random_magpie_weights as jax_random_weights
from magpie_tts_tpu.parallel.continuous import ContinuousBatchingEngine as JaxContinuous
from magpie_tts_tpu.parallel.serving import BatchedMagpieEngine as JaxBatchedEngine
from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu_torch.ops.kernels import decoder_step_batched as dsb
from magpie_tts_tpu_torch.ops.kernels import frame_step_batched as fsb
from magpie_tts_tpu_torch.ops.kernels import lt_sampler_batched as ltsb
from magpie_tts_tpu_torch.parallel.continuous import ContinuousBatchingEngine
from magpie_tts_tpu_torch.parallel.serving import BatchedMagpieEngine
from tests.test_torch_support import port_magpie_weights
from tests.utils import tiny_magpie_config

CONFIG = tiny_magpie_config()
GROUP = 4          # MAX_SLOTS in the grouped tests
SLOTS = 9          # three groups: 4 + 4 + 1
TOP_K = 8


# ------------------------------------------------------------ the group rule

@pytest.mark.parametrize("B", [1, 63, 64, 65, 96, 128, 129, 200])
def test_slot_groups_cover_every_slot_in_order(B):
    groups = fsb.slot_groups(B)
    assert [s for a, b in groups for s in range(a, b)] == list(range(B))
    assert all(1 <= b - a <= fsb.MAX_SLOTS for a, b in groups)
    assert len(groups) == -(-B // fsb.MAX_SLOTS)


def test_slot_groups_read_max_slots_at_call_time(monkeypatch):
    monkeypatch.setattr(fsb, "MAX_SLOTS", GROUP)
    assert fsb.slot_groups(SLOTS) == [(0, 4), (4, 8), (8, 9)]
    assert fsb.slot_groups(4) == [(0, 4)]


@pytest.mark.parametrize("B", [0, -1])
def test_slot_groups_refuse_no_slots(B):
    with pytest.raises(ValueError, match="at least 1"):
        fsb.slot_groups(B)


def test_launch_refuses_more_slots_than_a_launch_takes():
    """No launch of more than MAX_SLOTS reaches the library: the check comes
    before any tensor is read."""
    with pytest.raises(ValueError, match="a launch takes 1..64"):
        fsb.launch("magpie_frame_step_batched_f32", 65, {}, {}, CONFIG, torch.device("cpu"))


def test_slot_group_slices_only_the_slot_tensors():
    """A weight whose leading dim equals B is not sliced; a stride-0 row
    stays stride 0; a cache slice is a view of the caller's cache."""
    B, L = 12, 12
    cache = torch.zeros(B, L, 5, 3)
    valid = torch.ones(7, dtype=torch.bool)[None].expand(B, -1)
    g = fsb.slot_group({"k_cache": cache, "valid": valid, "qkv": torch.zeros(L, 3, 9),
                        "write_row": 2}, 4, 8)
    assert g["k_cache"].shape == (4, L, 5, 3) and g["k_cache"].is_contiguous()
    assert g["valid"].stride(0) == 0 and g["valid"].shape == (4, 7)
    assert g["qkv"].shape == (L, 3, 9) and g["write_row"] == 2
    g["k_cache"][0, 0, 0, 0] = 1.0
    assert cache[4, 0, 0, 0] == 1.0


# ------------------------------------- grouped wrappers against one plain call

def _rows(args, kwargs) -> int:
    """The slots of a plain call: its input rows (``hidden`` or ``x_pe``)."""
    return (args[0] if args else kwargs.get("hidden", kwargs.get("x_pe"))).shape[0]


def _frame_args(config, weights, B, broadcast, seed):
    """Kernel C's arguments for B slots: ring masks and gathered posemb rows,
    or (``broadcast``) one stride-0 valid row and one stride-0 posemb row as
    the lockstep loop passes them."""
    rng = np.random.default_rng(seed)
    L, S, D, E = config.dec_layers, config.max_seq, config.d_model, 16
    write_row = 30
    f32 = lambda *shape, s=0.5: torch.tensor(rng.normal(0, s, shape), dtype=torch.float32)
    if broadcast:
        valid = (torch.arange(S) < write_row)[None].expand(B, -1)
        posemb = weights.decoder.pos_emb[write_row][None].expand(B, -1)
    else:
        v = np.zeros((B, S), bool)
        for b in range(B - 1):
            v[b, (write_row + 1 + 3 * b + np.arange(10 + b)) % S] = True
        v[:, write_row] = False
        valid = torch.tensor(v)
        posemb = weights.decoder.pos_emb[torch.tensor(rng.integers(0, config.max_pos, B))]
    return dict(
        hidden=f32(B, D, s=1.0), write_row=write_row, valid=valid,
        may_continue=torch.tensor(rng.random(B) < 0.7), posemb=posemb,
        xa_k=f32(B, L, E, config.d_xa), xa_v=f32(B, L, E, config.d_xa),
        k_cache=f32(B, L, S, D), v_cache=f32(B, L, S, D),
        enc_lengths=torch.tensor(rng.integers(1, E + 1, B), dtype=torch.int32),
        seeds=torch.tensor(rng.integers(-2**31, 2**31, B), dtype=torch.int32),
        forbid_eos=torch.tensor(rng.random(B) < 0.3), weights=weights, config=config,
        top_k=TOP_K)


# (config, B, broadcast valid / posemb): B = 12 with 12 decoder layers is the
# case where the weights [L, K, N] lead with B.
DIRECT_CASES = {
    "ring_b9": (CONFIG, SLOTS, False),
    "broadcast_b9": (CONFIG, SLOTS, True),
    "ring_b12_l12": (dataclasses.replace(CONFIG, dec_layers=12), 12, False),
}


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("case", sorted(DIRECT_CASES))
def test_grouped_wrappers_equal_one_plain_call(monkeypatch, case, temperature):
    """Kernels C, 7 and 8 in groups of 4: codes, hidden rows and every cache
    row bit-equal to one ungrouped call of their plain versions, and each
    plain call given at most 4 slots."""
    config, B, broadcast = DIRECT_CASES[case]
    w = random_magpie_weights(config, seed=3)
    x = _frame_args(config, w, B, broadcast, seed=B + len(case))
    r = x["write_row"]
    base = {k: v for k, v in x.items() if k not in ("k_cache", "v_cache")}
    sample = (x["hidden"], w, config, x["seeds"], temperature, TOP_K, x["forbid_eos"])
    valid8 = x["valid"].clone()
    valid8[:, r] = True
    step = (x["hidden"], r, valid8, x["xa_k"], x["xa_v"])
    caches = lambda: (x["k_cache"].clone(), x["v_cache"].clone())
    with torch.no_grad():   # one ungrouped call of each plain version
        (kp, vp), (k8p, v8p) = caches(), caches()
        want = fsb.frame_step_batched_reference(k_cache=kp, v_cache=vp, temperature=temperature,
                                                **base)
        want7 = ltsb.sample_frame_codes_batched_reference(*sample)
        want8 = dsb.decode_step_batched_reference(*step, k8p, v8p, w, config, x["enc_lengths"])

    sizes = {"C": [], "7": [], "8": []}

    def counted(mod, name, key):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            sizes[key].append(_rows(a, k))
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)

    monkeypatch.setattr(fsb, "MAX_SLOTS", GROUP)
    counted(fsb, "frame_step_batched_reference", "C")
    counted(ltsb, "sample_frame_codes_batched_reference", "7")
    counted(dsb, "decode_step_batched_reference", "8")
    with torch.no_grad():
        (kg, vg), (k8, v8) = caches(), caches()
        got = fsb.frame_step_batched(k_cache=kg, v_cache=vg, temperature=temperature, **base)
        got7 = ltsb.sample_frame_codes_batched(*sample)
        h8 = dsb.decode_step_batched(*step, k8, v8, w, config, x["enc_lengths"])
    for a, b in zip(got[:3] + got7, want[:3] + want7):
        assert torch.equal(a, b)
    assert got[3] is kg and got[4] is vg
    for a, b in ((kg, kp), (vg, vp), (h8, want8), (k8, k8p), (v8, v8p)):
        assert torch.equal(a, b)
    want_sizes = [min(GROUP, B - a) for a in range(0, B, GROUP)]
    # kernel C's plain version runs 7 and 8's inside it, one call a group each
    assert sizes["C"] == want_sizes
    assert sizes["7"] == want_sizes * 2 and sizes["8"] == want_sizes * 2
    assert all(torch.isfinite(t).all() for t in (got[2], h8, kg, k8))


# ------------------------------------------------ the engines against JAX

@pytest.fixture(scope="module")
def weights():
    jw = jax_random_weights(CONFIG, seed=7)
    return jw, port_magpie_weights(jw)


@pytest.fixture
def groups_of_four(monkeypatch):
    """MAX_SLOTS lowered to 4; returns the slots of every plain frame call."""
    monkeypatch.setattr(fsb, "MAX_SLOTS", GROUP)
    seen = []
    for mod, name in ((fsb, "frame_step_batched_reference"),
                      (ltsb, "sample_frame_codes_batched_reference"),
                      (dsb, "decode_step_batched_reference")):
        fn = getattr(mod, name)

        def wrapper(*a, _fn=fn, **k):
            seen.append(_rows(a, k))
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)
    return seen


def _tokens(rng, n):
    return [CONFIG.text_bos_id] + [int(v) for v in rng.integers(2, 30, size=n)] + \
        [CONFIG.text_eos_id]


def _drive(engine, waves, temperature):
    """Submit wave 0, run one step, submit the later waves one per step, then
    pump until drained. Returns codes per request in submission order."""
    ids = [engine.submit(tok, seed=seed) for tok, seed in waves[0]]
    finished = dict(engine.step(temperature=temperature, top_k=TOP_K))
    for wave in waves[1:]:
        ids += [engine.submit(tok, seed=seed) for tok, seed in wave]
        finished.update(engine.step(temperature=temperature, top_k=TOP_K))
    while engine.pending:
        finished.update(engine.step(temperature=temperature, top_k=TOP_K))
    assert sorted(finished) == sorted(ids)
    return [finished[i] for i in ids]


# nine requests fill the nine slots across two token buckets; two more join
# when slots free; 5-frame segments
CONTINUOUS_WAVES = [[4, 20, 9, 6, 25, 12, 5, 7, 3], [10, 8]]
CONTINUOUS_BUCKETS, CONTINUOUS_SEGMENT = (16, 32), 5


@pytest.fixture(scope="module")
def continuous_jax(weights):
    """A fresh JAX engine at 9 slots (XLA: 9 is not a multiple of 8) for each
    temperature: an engine's ids and keys run on from one drive to the next."""
    jw, _ = weights
    rng = np.random.default_rng(21)
    waves = [[(_tokens(rng, n), 3 + i) for i, n in enumerate(wave)]
             for wave in CONTINUOUS_WAVES]
    engine = lambda: JaxContinuous(jw, CONFIG, n_slots=SLOTS, token_buckets=CONTINUOUS_BUCKETS,
                                   segment_frames=CONTINUOUS_SEGMENT)
    return waves, {temp: _drive(engine(), waves, temp) for temp in (0.0, 0.7)}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_continuous_in_groups_equals_jax(weights, continuous_jax, groups_of_four, fused,
                                         temperature):
    _, pw = weights
    waves, want = continuous_jax
    engine = ContinuousBatchingEngine(pw, CONFIG, n_slots=SLOTS, device="cpu",
                                      token_buckets=CONTINUOUS_BUCKETS,
                                      segment_frames=CONTINUOUS_SEGMENT, use_fused=fused)
    got = _drive(engine, waves, temperature)
    for i, (g, w) in enumerate(zip(got, want[temperature])):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert groups_of_four and max(groups_of_four) == GROUP and 1 in groups_of_four


@pytest.fixture(scope="module")
def lockstep_jax(weights):
    """The JAX lockstep engine at B = 9 (XLA), by temperature."""
    jw, _ = weights
    rng = np.random.default_rng(22)
    reqs = [_tokens(rng, n) for n in (4, 9, 12, 6, 20, 5, 8, 3)]
    engine = JaxBatchedEngine(jw, CONFIG, batch_size=SLOTS, token_buckets=(16, 32))
    spk = [b % 2 for b in range(len(reqs))]
    return reqs, spk, {temp: engine.synthesize_batch(reqs, temperature=temp, top_k=TOP_K,
                                                     seed=5, speaker_ids=spk)
                       for temp in (0.0, 0.7)}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_lockstep_in_groups_equals_jax(weights, lockstep_jax, groups_of_four, fused,
                                       temperature):
    """Eight requests padded to B = 9, run as groups 4 + 4 + 1."""
    _, pw = weights
    reqs, spk, want = lockstep_jax
    engine = BatchedMagpieEngine(pw, CONFIG, batch_size=SLOTS, device="cpu",
                                 token_buckets=(16, 32), use_fused=fused)
    got = engine.synthesize_batch(reqs, temperature=temperature, top_k=TOP_K, seed=5,
                                  speaker_ids=spk)
    assert [g.shape for g in got] == [w.shape for w in want[temperature]]
    for g, w in zip(got, want[temperature]):
        np.testing.assert_array_equal(g, w)
    assert set(groups_of_four) == {GROUP, 1}
