"""PyTorch port, the whole-loop parity scripts and the lockstep probe on the
CPU at the tiny config: ``scripts.parity_decode`` (3 texts x 40 frames) and
``scripts.parity_batched`` (B = 4 slots x 40 frames) run every arm on the
CPU, where the wrappers take their plain versions, and each arm's codes per
text and per slot must equal the JAX engine's on the XLA path for the same
weights (``random_magpie_weights(config, seed=0)`` in both packages), tokens
and seeds, at temp 0 and 0.7 (``MagpieEngine.synthesize_codes`` and
``synthesize_codes_batched_program``). Tolerance: none (exact codes and
lengths). The near-tie classifier and the scripts' ``main`` are checked too,
and ``probe_lockstep`` runs on the CPU by the host clock."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magpie_tts_tpu.io.magpie_weights import random_magpie_weights as jax_random_weights
from magpie_tts_tpu.models import magpie as jax_magpie
from magpie_tts_tpu.runtime.engine import MagpieEngine as JaxEngine
from magpie_tts_tpu_torch.io.magpie_weights import random_magpie_weights
from magpie_tts_tpu_torch.scripts import opt_slope_probe, parity_batched, parity_decode
from tests import test_torch_support  # noqa: F401  (one intra-op thread per worker)
from tests.utils import tiny_magpie_config

FRAMES, TEXTS, B = 40, 3, 4
CPU = torch.device("cpu")
BASE = tiny_magpie_config()
CONFIG = parity_decode.parity_config(FRAMES, BASE)


@pytest.fixture(scope="module")
def weights():
    return (jax_random_weights(CONFIG, seed=parity_decode.WEIGHT_SEED),
            random_magpie_weights(CONFIG, seed=parity_decode.WEIGHT_SEED))


@pytest.fixture(scope="module")
def jax_engine(weights):
    """The JAX script's ``xla`` arm; its programs compile once per bucket."""
    return JaxEngine(weights[0], CONFIG, use_pallas_lt=False, use_pallas_decoder=False)


@pytest.fixture(scope="module")
def jax_batched():
    """The JAX lockstep program on the XLA path, compiled once (temp traced)."""
    return jax.jit(lambda w, t, l, s, k, tp: jax_magpie.synthesize_codes_batched_program(
        t, l, s, k, tp, w, CONFIG, top_k=parity_decode.TOP_K, use_pallas_decoder=False))


@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_parity_decode_arms_equal_jax(weights, jax_engine, temp):
    _, pw = weights
    tokens = parity_decode.make_token_lists(CONFIG, TEXTS)
    res = parity_decode.run_parity(CONFIG, pw, tokens, ("fused", "split", "plain"), CPU,
                                   temperature=temp)
    assert res["ok"] and res["near_ties"] == 0
    assert len(res["pairs"]) == 3 * TEXTS
    for i, toks in enumerate(tokens):
        want = jax_engine.synthesize_codes(toks, temperature=temp, top_k=parity_decode.TOP_K,
                                           seed=parity_decode.RUN_SEED)
        assert want.n_frames == FRAMES
        for arm, run in res["arms"].items():
            np.testing.assert_array_equal(run["codes"][i], np.asarray(want.codes),
                                          err_msg=f"{arm} text {i}")
            assert run["launches"] == {"A": 0, "4": 0, "5": 0}


def _jax_batched(fn, jw, inputs, temp):
    keys = jnp.asarray(np.array(inputs["keys"], np.uint32))
    codes, n = fn(jw, jnp.asarray(inputs["tokens"], jnp.int32),
                  jnp.asarray(inputs["lens"], jnp.int32), jnp.zeros((B,), jnp.int32), keys,
                  jnp.float32(temp))
    return np.asarray(codes), np.asarray(n)


@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_parity_batched_arms_equal_jax(weights, jax_batched, temp):
    jw, pw = weights
    inputs = parity_batched.make_inputs(CONFIG, B, 0)
    res = parity_batched.run_parity(CONFIG, pw, inputs, ("fused", "split", "plain"), CPU,
                                    temperature=temp, plain_batch=2)
    assert res["ok"] and res["near_ties"] == 0
    want_codes, want_n = _jax_batched(jax_batched, jw, inputs, temp)
    for arm, run in res["arms"].items():
        slots = 2 if arm == "plain" else B
        np.testing.assert_array_equal(run["n_frames"], want_n[:slots], err_msg=arm)
        for b in range(slots):
            np.testing.assert_array_equal(run["codes"][b, :want_n[b]],
                                          want_codes[b, :want_n[b]], err_msg=f"{arm} {b}")
        assert run["launches"] == {"C": 0, "7": 0, "8": 0}


def test_batched_keys_are_the_jax_scripts(weights):
    """make_inputs' keys are fold_in(PRNGKey(seed), i), as the JAX script's vmap."""
    inputs = parity_batched.make_inputs(CONFIG, B, 3)
    want = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(jnp.arange(B))
    np.testing.assert_array_equal(np.array(inputs["keys"], np.uint32),
                                  np.asarray(want, np.uint32))


def test_parity_decode_main_passes_on_cpu(capsys):
    assert parity_decode.main(["--device", "cpu", "--frames", str(FRAMES), "--texts",
                               str(TEXTS)], base_config=BASE) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("parity: PASS")
    assert out.count("EXACT") == 3 * TEXTS   # three pairs of arms x the texts


def test_parity_batched_main_passes_on_cpu(capsys):
    assert parity_batched.main(["--device", "cpu", "--batch", str(B), "--frames", "6"],
                               base_config=BASE) == 0
    out = capsys.readouterr().out
    assert "parity: fused vs split: IDENTICAL over 4 slots" in out
    assert "fused batched loop:" in out and "split batched loop:" in out
    assert out.strip().endswith("parity: PASS")


def test_main_without_a_card_exits_1():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        parity_decode.main(["--device", "cuda", "--frames", "2"], base_config=BASE)
    assert e.value.code == 1


def _plain_hidden_and_codes(pw, temp, seed, forbid):
    from magpie_tts_tpu_torch.ops.kernels.lt_sampler import sample_frame_codes_reference

    hidden = torch.from_numpy(np.random.default_rng(5).normal(0, 1, CONFIG.d_model)
                              .astype(np.float32))
    sampled, _ = sample_frame_codes_reference(hidden, pw, CONFIG, seed, temp, 80, forbid)
    return hidden, sampled.tolist()


@pytest.mark.parametrize("temp", [0.0, 0.7])
def test_frame_gaps_of_the_plain_sampler(weights, temp):
    """The plain sampler's own codes part from no winner; a code replaced by
    another has a positive gap, and a gap below one bf16 ulp is a near-tie."""
    _, pw = weights
    hidden, codes = _plain_hidden_and_codes(pw, temp, 1234, False)
    assert parity_decode.frame_gaps(hidden, codes, pw, CONFIG, 1234, temp, 80, False) == []
    other = list(codes)
    other[3] = (codes[3] + 1) % CONFIG.codebook_size
    gaps = parity_decode.frame_gaps(hidden, other, pw, CONFIG, 1234, temp, 80, False)
    assert [g[0] for g in gaps][:1] == [3] and gaps[0][1] > 0 and gaps[0][2] > 0
    assert parity_decode.is_near_tie([(3, 0.5 * gaps[0][2], gaps[0][2])])
    assert not parity_decode.is_near_tie([(3, 2 * gaps[0][2], gaps[0][2])])
    assert not parity_decode.is_near_tie([])


def _codebook0_logits(pw, hidden):
    """The plain LT's masked codebook-0 logits on ``hidden``, recomputed."""
    from magpie_tts_tpu_torch.models import local_transformer as lt_mod
    from magpie_tts_tpu_torch.ops import sampling
    from magpie_tts_tpu_torch.ops.precision import matmul_f32

    seq = torch.zeros(lt_mod._MAX_SEQ, CONFIG.lt_dim)
    seq[0] = lt_mod._in_proj(hidden, pw.lt)
    logits = matmul_f32(lt_mod._lt_layer_f32(seq, pw.lt, CONFIG)[0], pw.lt.out_proj_w[0]) + \
        pw.lt.out_proj_b[0].float()
    return sampling.mask_logits(logits, sampling.forbidden_token_mask(
        CONFIG.vocab_per_cb, CONFIG.audio_bos_id), False, CONFIG.audio_eos_id)


def _close_the_edge(pw, logits, order, k):
    """Weights whose codebook-0 (k+1)-th logit sits just under its k-th (the
    output bias moved): the exact top-k set's edge is a near-tie."""
    bias = pw.lt.out_proj_b.clone()
    bias[0, order[k]] += float(logits[order[k - 1]] - logits[order[k]]) * (1 - 1e-3)
    return dataclasses.replace(pw, lt=dataclasses.replace(pw.lt, out_proj_b=bias))


def test_frame_gaps_top_k_edge(weights):
    """At temp 0.7 a code just outside the exact top-k set, within one bf16
    ulp of its k-th logit, is a near-tie of the set's edge; one far outside
    is not. Codebook 0's (k+1)-th logit is moved to just under its k-th
    through the output bias, the plain LT's logits recomputed here."""
    _, pw = weights
    hidden, codes = _plain_hidden_and_codes(pw, 0.7, 1234, False)
    logits = _codebook0_logits(pw, hidden)
    order = torch.argsort(logits, descending=True).tolist()
    k = 10
    w = _close_the_edge(pw, logits, order, k)
    near = parity_decode.frame_gaps(hidden, [order[k]] + codes[1:], w, CONFIG, 1234, 0.7, k,
                                    False)
    assert near[0][0] == 0 and near[0][3] == "top-k edge" and parity_decode.is_near_tie(near[:1])
    far = parity_decode.frame_gaps(hidden, [order[-1]] + codes[1:], w, CONFIG, 1234, 0.7, k,
                                   False)
    assert far[0][3] == "argmax" and not parity_decode.is_near_tie(far[:1])


@pytest.mark.parametrize("case", ["kth_itself", "winner_leaves", "not_runner_up",
                                  "enters_at_temp_1"])
def test_frame_gaps_top_k_edge_cases(weights, case):
    """The edge that decides membership is the k-th logit against the best
    one outside the set. With that edge a near-tie: the k-th code itself,
    when the argmax gap is wide, is a MISMATCH (no edge lies between it and
    the winner); the runner-up is a near-tie when the winner is the k-th and
    may leave the set, another code of the set is not; a code entering the
    set is a near-tie at temp 1.0 too."""
    from magpie_tts_tpu_torch.ops import sampling

    _, pw = weights
    temp = 1.0 if case == "enters_at_temp_1" else 0.7
    hidden, codes = _plain_hidden_and_codes(pw, temp, 1234, False)
    logits = _codebook0_logits(pw, hidden)
    order = torch.argsort(logits, descending=True).tolist()
    g = sampling.gumbel_from_seed(sampling.phase_seed(1234, 0),
                                  torch.arange(CONFIG.vocab_per_cb))
    z = (logits / temp + g).tolist()
    if case == "winner_leaves" or case == "not_runner_up":
        # the smallest k whose k-th logit has the set's best score
        k = next(k for k in range(2, len(order))
                 if z[order[k - 1]] > max(z[i] for i in order[:k - 1]))
    else:
        k = 10
    w = _close_the_edge(pw, logits, order, k)
    members = order[:k]
    want = max(members, key=lambda i: z[i])
    runner_up = max((i for i in members if i != want), key=lambda i: z[i])
    got = {"kth_itself": order[k - 1], "winner_leaves": runner_up,
           "not_runner_up": min((i for i in members if i != want), key=lambda i: z[i]),
           "enters_at_temp_1": order[k]}[case]
    assert got != want and (case != "kth_itself" or got != runner_up)
    gaps = parity_decode.frame_gaps(hidden, [got] + codes[1:], w, CONFIG, 1234, temp, k, False)
    assert gaps[0][0] == 0
    if case in ("winner_leaves", "enters_at_temp_1"):
        assert gaps[0][3] == "top-k edge" and parity_decode.is_near_tie(gaps[:1]), gaps
    else:
        assert gaps[0][3] == "argmax" and not parity_decode.is_near_tie(gaps[:1]), gaps
        res = parity_decode.compare_rows(
            "text 0", "plain", "fused", np.array([[want] + codes[1:]]),
            np.array([[got] + codes[1:]]), False, lambda f, ra, rb: gaps[:1])
        assert res["status"] == "MISMATCH" and not res["ok"]


@pytest.mark.parametrize("case", ["exact", "near_tie", "near_tie_exact_only", "mismatch",
                                  "length"])
def test_compare_rows_verdicts(case):
    a = np.arange(24, dtype=np.int32).reshape(3, 8)
    b = a.copy()
    gaps = []
    if case != "exact":
        b[1, 2] += 1
        gaps = [(2, 0.001, 0.01)] if case.startswith("near_tie") else [(2, 1.0, 0.01)]
    if case == "length":
        b = a[:2]
    res = parity_decode.compare_rows("text 0", "plain", "fused", a, b,
                                     case == "near_tie_exact_only", lambda f, ra, rb: gaps)
    want = {"exact": ("EXACT", True), "near_tie": ("NEAR-TIE", True),
            "near_tie_exact_only": ("NEAR-TIE", False), "mismatch": ("MISMATCH", False),
            "length": ("MISMATCH", False)}[case]
    assert (res["status"], res["ok"]) == want
    if case in ("near_tie", "mismatch"):
        assert res["frame"] == 1 and "first mismatched frame: 1" in res["line"]


def test_launch_check_refuses_a_plain_card_arm():
    """A card arm whose kernel never launched (it ran plain) fails."""
    cuda = torch.device("cuda")
    parity_decode.check_launches("fused", cuda, {"A": 40, "4": 0, "5": 0}, 40)
    with pytest.raises(RuntimeError):
        parity_decode.check_launches("fused", cuda, {"A": 0, "4": 0, "5": 0}, 40)
    with pytest.raises(RuntimeError):
        parity_decode.check_launches("split", cuda, {"A": 3, "4": 40, "5": 40}, 40)
    with pytest.raises(RuntimeError):
        parity_decode.check_launches("fused", CPU, {"C": 1, "7": 0, "8": 0}, 0, batched=True)


def test_probe_lockstep_on_cpu():
    assert "lockstep" in opt_slope_probe.PROBES and "lockstep" not in opt_slope_probe.NOT_PORTED
    small = dataclasses.replace(BASE, max_dec_steps=8)
    out = opt_slope_probe.probe_lockstep(CPU, n_lo=2, n_hi=4, reps=1, config=small, B=2)
    assert [o["kernel"] for o in out] == ["C", "7+8"]
    for o in out:
        assert o["host"]["clock"] == "host" and np.isfinite(o["host_ms"])
        assert (o["host"]["n_lo"], o["host"]["n_hi"]) == (2, 4)
