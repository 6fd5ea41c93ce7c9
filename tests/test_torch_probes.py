"""The H100 probes (TPU kernels 11-18) on the CPU: each plain version of the
port's probe kernels (magpie_tts_tpu_torch/ops/kernels/probe_*.py) against
the JAX probe script's Pallas kernel, run in interpret mode on the same numpy
inputs, and the probe scripts' own paths at tiny counts.

The JAX scripts under scripts/ are not a package: each is loaded from its
path with MAGPIE_COMPILATION_CACHE=0 (two of them enable the compilation
cache at import), its ``pl`` swapped for a namespace whose ``pallas_call``
runs in interpret mode, and its timing helper (``timed`` / ``slope``)
replaced by one that keeps the outputs. Nothing under scripts/ changes.

Tolerances: kernels 11 and 12 bit-equal (integer weights, x = ones: every
sum is an exact integer); 13 within 1e-5 of the largest value (float32 sums
in another order); 14 and 18 within 5e-4 of the largest value (a probability
near a bf16 boundary moves by one ulp when float32 sums run in another
order); 15-17 bit-equal, their chained bf16 adds included.
"""

import contextlib
import functools
import importlib.util
import inspect
import os
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from magpie_tts_tpu_torch.ops.kernels import probe_attend, probe_copy, probe_gemv
from magpie_tts_tpu_torch.scripts import (opt_attend_probe, opt_int8_attend_probe,
                                          opt_launch_probe, opt_slope_probe, probe_int4, timing)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
ATTEND_REL = 5e-4
GEMV_BF16_REL = 1e-5


@contextlib.contextmanager
def _env(name, value):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


@functools.lru_cache(maxsize=None)
def jax_script(name: str):
    """scripts/<name>.py, loaded from its path, its Pallas calls in interpret mode."""
    spec = importlib.util.spec_from_file_location(f"_jax_probe_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    with _env("MAGPIE_COMPILATION_CACHE", "0"):
        spec.loader.exec_module(mod)
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = ns
    return mod


def f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def to_jax(t: torch.Tensor):
    """A torch tensor as a jax array of the same dtype (bf16 through float32, exact)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


# ---------------------------------------------------------------- GEMV 11-13


@functools.lru_cache(maxsize=None)
def jax_gemv_outputs():
    mod = jax_script("probe_int4")
    outs = []

    def keep(fn, *args, n=30):
        outs.append(np.asarray(fn(*args)))
        return outs[-1], 0.0

    mod.timed = keep
    errs = {"native_int4": mod.probe_native_int4()[1], "packed_int8": mod.probe_packed_int8()[1]}
    mod.probe_bf16()
    return dict(zip(("native_int4", "packed_int8", "bf16"), outs)), errs


@pytest.mark.parametrize("fmt", ["native_int4", "packed_int8"])
def test_gemv_nibble_plain_bit_equal_jax(fmt):
    """Kernels 11 / 12: the plain version equals the Pallas probe bit for bit,
    and both equal the exact integer product."""
    outs, errs = jax_gemv_outputs()
    x, w, _, wint = probe_int4.make_inputs(CPU)[fmt]
    got = probe_gemv.gemv(x, w, fmt).numpy()
    np.testing.assert_array_equal(got, outs[fmt])
    np.testing.assert_array_equal(got, np.ones((8, 768), np.float32) @ wint.astype(np.float32))
    assert errs[fmt] == 0.0


def test_gemv_bf16_plain_matches_jax():
    outs, _ = jax_gemv_outputs()
    x, w, _, _ = probe_int4.make_inputs(CPU)["bf16"]
    got, want = probe_gemv.gemv(x, w, "bf16").numpy(), outs["bf16"]
    assert np.abs(got - want).max() <= GEMV_BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("fmt", ["native_int4", "packed_int8"])
def test_gemv_packings_round_trip(fmt):
    """The port's packers and unpackers against the probe's formulas."""
    w = np.random.default_rng(5).integers(-8, 8, size=(128, 192))
    pack = probe_gemv.pack_native_int4 if fmt == "native_int4" else probe_gemv.pack_int8
    packed = torch.from_numpy(pack(w))
    np.testing.assert_array_equal(probe_gemv.unpack(packed, fmt).numpy(), w)
    if fmt == "native_int4":   # element order: byte j holds columns 2j (low), 2j + 1 (high)
        np.testing.assert_array_equal(packed.numpy() & 15, w[:, 0::2] & 15)
    else:                      # scripts/probe_int4.py probe_packed_int8's packing
        np.testing.assert_array_equal(
            packed.numpy(), ((w[64:] & 15) << 4 | (w[:64] & 15)).astype(np.int8))


# ------------------------------------------------------------- attend 14, 18


@functools.lru_cache(maxsize=None)
def int8_inputs():
    return opt_int8_attend_probe.make_inputs(CPU)


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("rows", [320, 640])
@pytest.mark.parametrize("mode", ["bf16", "i8mixed", "i8cast"])
def test_int8_attend_plain_matches_jax(mode, rows, iters):
    """Kernel 14's plain version against scripts/opt_int8_attend_probe.py's
    Pallas kernel in interpret mode, on the probe's own quantized inputs."""
    x = opt_int8_attend_probe.inputs_for(mode, int8_inputs())
    args = [x[n] for n in ("q", "k", "v", "sk", "sv")]
    want = f32(jax_script("opt_int8_attend_probe").run(mode, rows, iters,
                                                        *[to_jax(a) for a in args]))
    got = probe_attend.attend(*args, rows, iters, mode).numpy()
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(got - want).max() <= ATTEND_REL * scale


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("rows", [320, 640])
@pytest.mark.parametrize("mode", ["cur", "tr"])
def test_attend_orientations_plain_match_jax(mode, rows, iters):
    """Kernel 18's plain version (both orientations compute one function)
    against scripts/opt_attend_probe.py's Pallas kernel in interpret mode."""
    x = opt_attend_probe.make_inputs(CPU)
    want = f32(jax_script("opt_attend_probe").run(mode, rows, iters,
                                                   *[to_jax(x[n]) for n in ("q", "k", "v")]))
    got = probe_attend.attend(x["q"], x["k"], x["v"], None, None, rows, iters, mode).numpy()
    assert np.abs(got - want).max() <= ATTEND_REL * np.abs(want).max()


def test_attend_sum_over_iters_is_in_order():
    """``iters`` attends are added in order in float32: the per-launch
    accumulate and the whole reference give the same bits."""
    x = opt_attend_probe.make_inputs(CPU)
    args = (x["q"], x["k"], x["v"], None, None, 100)
    out = torch.zeros(8, 768)
    for _ in range(3):
        probe_attend.attend_accumulate(out, *args, "cur")
    assert torch.equal(out, probe_attend.attend_reference(*args, 3, "cur"))


def _attend_inputs(mode: str) -> dict:
    return (opt_int8_attend_probe.inputs_for(mode, int8_inputs())
            if mode in ("bf16", "i8mixed", "i8cast") else opt_attend_probe.make_inputs(CPU))


def _attend_args(mode: str, x=None, slots=None) -> list:
    x = _attend_inputs(mode) if x is None else x
    args = [x[n] for n in ("q", "k", "v", "sk", "sv")]
    if slots is not None:
        args = [None if a is None else a[slots].contiguous() for a in args]
    return args


@functools.lru_cache(maxsize=None)
def jax_attend_once(mode: str, rows: int) -> np.ndarray:
    """One attend (iters 1) of the mode's Pallas probe in interpret mode."""
    args = _attend_args(mode)
    if mode in ("cur", "tr"):
        return f32(jax_script("opt_attend_probe").run(mode, rows, 1,
                                                      *[to_jax(a) for a in args[:3]]))
    return f32(jax_script("opt_int8_attend_probe").run(mode, rows, 1,
                                                       *[to_jax(a) for a in args]))


@pytest.mark.parametrize("rows", [320, 640])
@pytest.mark.parametrize("mode", probe_attend.MODES)
def test_attend_chunked_model_matches_plain_and_jax(mode, rows):
    """The CPU model of the redesigned kernel (the plan's chunks, chunk
    partials merged in chunk order, probabilities rounded after normalising)
    against the plain version and the Pallas probe in interpret mode, within
    ATTEND_REL of the largest value (a probability near a bf16 boundary moves
    by one ulp when the sum of exponentials runs in another order)."""
    args = _attend_args(mode)
    got = probe_attend.chunked_model(*args, rows, mode)
    plain = probe_attend.attend_once_reference(*args, rows, mode)
    assert float((got - plain).abs().max()) <= ATTEND_REL * float(plain.abs().max())
    want = jax_attend_once(mode, rows)
    assert np.abs(got.numpy() - want).max() <= ATTEND_REL * np.abs(want).max()


@pytest.mark.parametrize("rows", [1, 63, 65, 639])
@pytest.mark.parametrize("mode", probe_attend.MODES)
def test_attend_chunked_model_ragged_rows(mode, rows):
    """Rows that are not a multiple of the chunk (a last chunk of 1 row, one
    row short of or past a chunk): the model against plain, ATTEND_REL."""
    args = _attend_args(mode)
    got = probe_attend.chunked_model(*args, rows, mode)
    plain = probe_attend.attend_once_reference(*args, rows, mode)
    assert float((got - plain).abs().max()) <= ATTEND_REL * float(plain.abs().max())


@pytest.mark.parametrize("mode", probe_attend.MODES)
def test_attend_slot_bits_do_not_depend_on_the_slot_count(mode):
    """A slot's result is bit-equal alone (G = 1) and among 8 slots: the
    model's items, like the kernel's, are per slot."""
    args8 = _attend_args(mode)
    many = probe_attend.chunked_model(*args8, 640, mode)
    for b in (0, 5):
        one = probe_attend.chunked_model(*_attend_args(mode, slots=slice(b, b + 1)), 640, mode)
        assert torch.equal(one[0], many[b])


@pytest.mark.parametrize("mode", probe_attend.MODES)
def test_attend_plan_does_not_depend_on_the_slot_count(mode):
    """The plan takes the mode and the head width alone; a launch's blocks
    are G times a slot's; at G = 8 and 640 rows every mode has at least two
    blocks an SM of the H100 (2 x 132); a slot's blocks hold every row
    once, in chunks dealt round robin; cur's workspace is the kernel's
    layout."""
    assert list(inspect.signature(probe_attend.plan_attend).parameters) == ["mode", "d_head"]
    plan = probe_attend.plan_attend(mode)
    per_slot = plan.blocks(1, 12, 640)
    assert all(plan.blocks(G, 12, 640) == G * per_slot for G in (1, 3, 8, 64))
    assert plan.blocks(8, 12, 640) >= 2 * 132
    for rows in (1, 63, 320, 639, 640):
        b = plan.bounds(rows)
        assert b[0][0] == 0 and b[-1][1] == rows and len(b) == plan.chunks(rows)
        assert all(r1 == b[i + 1][0] for i, (_, r1) in enumerate(b[:-1]))
        for split in (plan.groups(rows), plan.partials(rows)):
            assert sorted(r for grp in split for r in grp) == list(range(rows))
    if mode == "cur":
        assert (plan.chunk, plan.cluster) == (16, 0)
        assert probe_attend.workspace_words(8, 768, 640) == 8 * (12 * 640 + 12 * 40 * 2 +
                                                                   40 * 768)
    else:
        assert plan.chunk * 64 * (1 if mode.startswith("i8") else 2) == 2048
        c = plan.chunk
        assert plan.cluster == 8 and len(plan.partials(640)) == 32
        assert plan.groups(640)[3][c - 1:c + 1] == [4 * c - 1, 11 * c]
        # warp 1 of CTA 3: local rows 32 .., i.e. row 32 % c of its chunk 32 // c
        first = (3 + 8 * (32 // c)) * c + 32 % c
        assert plan.partials(640)[4 * 3 + 1][:2] == [first, first + 1]


# ----------------------------------------------------------- copies 15-17


@functools.lru_cache(maxsize=None)
def jax_slope_outputs():
    """probe_minimal / probe_constblk chained n = 3 times from their init at
    rep 1, in interpret mode: {name: (init, out)}."""
    mod = jax_script("opt_slope_probe")
    outs = {}

    def keep(label, make_run, init_fn, *args):
        init = init_fn(1)
        outs[label.split()[0]] = (f32(init), f32(make_run(3)(init, *args)))

    mod.slope = keep
    mod.probe_minimal()
    mod.probe_constblk()
    return outs


@pytest.mark.parametrize("variant", ["minimal", "constblk"])
def test_slope_copy_plain_bit_equal_jax(variant):
    """Kernels 15 / 16: three chained launches at grid 8, bit-equal."""
    init, want = jax_slope_outputs()["minimal" if variant == "minimal" else "+10"]
    consts = opt_slope_probe.const_blocks(CPU) if variant == "constblk" else ()
    h = torch.from_numpy(np.array(init)).to(torch.bfloat16)
    for _ in range(3):
        h, cs = probe_copy.copy(h, 8, consts=consts)
    np.testing.assert_array_equal(h.float().numpy(), want)


@pytest.mark.parametrize("grid_n,streamed", [(1, 0), (8, 0), (20, 0), (8, 1)])
def test_launch_copy_plain_bit_equal_jax(grid_n, streamed):
    """Kernel 17 at grid 1 / 8 / 20 and streamed at grid 8, chained 100 times
    from zeros, bit-equal to the Pallas chain; at grid 8, 764 (bf16 rounds the
    add every launch: above 256 its spacing is 2)."""
    fn, x0 = jax_script("opt_launch_probe").minimal_probe(32, grid_n, streamed_mb=streamed)
    want = f32(fn(x0))
    body, h, _ = opt_launch_probe.minimal_probe(32, grid_n, streamed, CPU)
    got = timing.chain(body, h, opt_launch_probe.ITERS).float().numpy()
    np.testing.assert_array_equal(got, want)
    if (grid_n, streamed) == (8, 0):
        assert np.all(got == 764.0)


@pytest.mark.parametrize("grid_n", [1, 3, 8, 20])
def test_copy_checksums_are_the_xor_of_the_words_read(grid_n):
    """The plain version's per-block partials: block i's share of x and of
    every constant block (words [i n / g, (i + 1) n / g)) and slab i, XORed;
    checked against numpy, and the partials fold to the XOR of everything."""
    rng = np.random.default_rng(grid_n)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s)).to(torch.bfloat16)
    x, consts, slab = bf(32, 768), [bf(8, 256), bf(7, 6)], bf(grid_n, 4, 64)
    words = lambda t: t.reshape(-1).view(torch.int32).numpy()
    for kw in ({}, {"consts": consts}, {"slab": slab}):
        _, cs = probe_copy.copy(x, grid_n, **kw)
        want = []
        for i in range(grid_n):
            acc = 0
            for t in (x, *kw.get("consts", ())):
                w = words(t)
                acc ^= int(np.bitwise_xor.reduce(w[i * w.size // grid_n:(i + 1) * w.size // grid_n],
                                                 initial=0))
            if "slab" in kw:
                acc ^= int(np.bitwise_xor.reduce(words(slab[i]), initial=0))
            want.append(acc)
        np.testing.assert_array_equal(cs.numpy(), np.array(want, np.int64).astype(np.int32))
        every = [words(t) for t in (x, *kw.get("consts", ()))] + (
            [words(slab)] if "slab" in kw else [])
        assert int(probe_copy.xor_reduce(cs)) == int(np.bitwise_xor.reduce(np.concatenate(every)))


def test_streamed_copy_adds_the_last_slab_element():
    x = torch.full((2, 8), 3.0, dtype=torch.bfloat16)
    slab = torch.zeros(4, 2, 8, dtype=torch.bfloat16)
    slab[3, 0, 0] = 0.5
    slab[2, 0, 0] = 100.0
    out, _ = probe_copy.copy(x, 4, slab=slab)
    assert torch.equal(out, torch.full((2, 8), 3.5, dtype=torch.bfloat16))


# ------------------------------------------------ the probe scripts' paths


def test_timing_slopes_on_the_cpu_use_the_host_clock():
    body = lambda i, h: probe_copy.copy(h, 8)[0]
    x0 = torch.zeros(32, 768, dtype=torch.bfloat16)
    for fn in (timing.graph_slope, timing.eager_slope):
        res = fn(body, x0, 2, 6, reps=1)
        assert res["clock"] == "host" and res["t_hi_ms"] > 0 and (res["n_lo"], res["n_hi"]) == (2, 6)
    assert timing.event_mean(lambda: body(0, x0), 2, device="cpu") > 0


def test_bounds_and_rotation_from_the_shapes():
    """Bounds from the probe shapes: int4 weight 1.29 MB -> 0.385 us, bf16
    4.83 MB -> 1.44 us; the attend's bytes per row; rotations pass 50 MB."""
    x, w, _, _ = probe_int4.make_inputs(CPU)["native_int4"]
    b = timing.bound(*probe_int4.gemv_work(w))
    assert b["bound_by"] == "bytes" and abs(b["bound_ms"] * 1e3 - 0.3853) < 1e-3
    _, wb, _, _ = probe_int4.make_inputs(CPU)["bf16"]
    assert abs(timing.bound(*probe_int4.gemv_work(wb))["bound_ms"] * 1e3 - 1.442) < 1e-3
    nb, _ = opt_attend_probe.attend_work("bf16", 640)
    assert nb == 8 * (640 * 768 * 4 + 768 * 2 + 768 * 8)
    for nbytes in (1179648, 4718592, 15728640, 8388608):
        assert timing.copies_past_l2(nbytes) * nbytes > timing.L2_BYTES


@pytest.mark.parametrize("fmt", probe_gemv.FORMATS)
def test_probe_int4_path_on_the_cpu(fmt):
    res = probe_int4.probe(fmt, CPU, n_lo=1, n_hi=2, reps=1, timed_n=1)
    assert res["max_abs_err"] <= GEMV_BF16_REL * res["max_abs_ref"] and res["bit_equal_plain"]
    assert res["hbm_copies"] * res["bytes"] > timing.L2_BYTES
    assert "max err" in probe_int4.report(res)


@pytest.mark.parametrize("mode", ["cur", "tr", "i8mixed"])
def test_attend_probe_paths_on_the_cpu(mode):
    x = (opt_int8_attend_probe.inputs_for(mode, int8_inputs()) if mode.startswith("i8")
         else opt_attend_probe.make_inputs(CPU))
    assert opt_attend_probe.agreement(mode, 64, 1, x)["rel_err"] == 0.0
    res = opt_attend_probe.slopes(mode, 64, x, CPU, i_lo=1, i_hi=2, reps=1)
    assert res["hbm_copies"] >= 4 and "ns/slot-attend" in opt_attend_probe.report(res)


def test_copy_probe_paths_on_the_cpu():
    for fn in (opt_slope_probe.probe_minimal, opt_slope_probe.probe_constblk):
        res = fn(CPU, n_lo=1, n_hi=2, reps=1)
        assert res["graph"]["clock"] == "host"
    res = opt_launch_probe.run("streamed", 32, 8, 1, CPU, n_lo=1, n_hi=2, reps=1, iters=4)
    assert res["bit_equal_plain"] and res["hbm_copies"] == 8


@pytest.mark.parametrize("module", [probe_int4, opt_int8_attend_probe, opt_attend_probe,
                                    opt_slope_probe, opt_launch_probe])
def test_probe_entry_points_default_to_the_card(module, monkeypatch):
    """Without a card and without --device cpu every probe exits non-zero
    (no fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        module.main([])
    assert e.value.code == 1


def test_slope_probe_refuses_unported_probes():
    assert opt_slope_probe.main(["anatomy", "--device", "cpu"]) == 2
    assert opt_slope_probe.main(["no_such_probe", "--device", "cpu"]) == 2
    # lockstep is ported (tests/test_torch_parity_scripts.py runs it on the CPU)
    assert "lockstep" in opt_slope_probe.PROBES and "lockstep" not in opt_slope_probe.NOT_PORTED
