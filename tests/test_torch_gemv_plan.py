"""Kernels 11-13 (the native-int4, packed-int8 and bf16 GEMV probes) split
K across the card: their launch plan (``probe_gemv.plan_gemv``; a
packed-int8 split reads byte rows that hold two ranges of K) and a CPU
model of their sum order (``probe_gemv.split_model``: per-split float32
partials, then a rank-order sum), held against the plain version and
against the JAX probe's Pallas kernels in interpret mode
(scripts/probe_int4.py, loaded as tests/test_torch_probes.py loads it).

Tolerances: the nibble formats bit-equal (integer weights and x = ones or
small integers: every partial sum is an exact integer below 2^24, so any
order gives the same bits); bf16 within 1e-5 of the largest value (float32
sums in another order).
"""

import dataclasses
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.ops.kernels import probe_gemv
from magpie_tts_tpu_torch.scripts import probe_int4
from tests.test_torch_probes import GEMV_BF16_REL, jax_gemv_outputs

CPU = torch.device("cpu")
SMS = 132  # the H100's SMs
SOURCE = Path(probe_gemv.__file__).resolve().parents[2] / "csrc" / "probe_gemv.cu"


def _close(fmt, got, want) -> bool:
    if fmt == "bf16":
        return float((got - want).abs().max()) <= GEMV_BF16_REL * float(want.abs().max())
    return torch.equal(got, want)


@pytest.mark.parametrize("fmt", probe_gemv.FORMATS)
def test_plan_at_the_probe_shape(fmt):
    """At (768, 3072): at least one CTA an SM, a cluster of at most 8, and
    splits of whole mma steps that tile K exactly (packed_int8: each split
    the same byte rows' two ranges of K)."""
    plan = probe_gemv.plan_gemv(fmt, 768, 3072)
    assert plan.ctas >= SMS and 1 < plan.cluster <= 8
    assert plan.splits * plan.kchunk == 768 and plan.kchunk % probe_gemv.STEP == 0
    if fmt == "packed_int8":
        assert (plan.tiles, plan.splits, plan.kchunk, plan.ctas) == (48, 3, 256, 144)
        assert plan.bounds() == [((0, 128), (384, 512)), ((128, 256), (512, 640)),
                                 ((256, 384), (640, 768))]
    else:
        assert (plan.tiles, plan.splits, plan.kchunk, plan.ctas) == (48, 4, 192, 192)
        assert plan.bounds() == [(0, 192), (192, 384), (384, 576), (576, 768)]


def test_plan_takes_only_the_format_and_the_shapes():
    """The plan is a function of (fmt, K, N) alone, so the sum order and the
    bits are fixed by them; kernel 12 splits K over a cluster too, by its
    own rule (3 splits at K 768)."""
    assert list(inspect.signature(probe_gemv.plan_gemv).parameters) == ["fmt", "K", "N"]
    for fmt in probe_gemv.FORMATS:
        assert probe_gemv.plan_gemv(fmt, 512, 1024) == probe_gemv.plan_gemv(fmt, 512, 1024)
    assert probe_gemv.plan_gemv("bf16", 1024, 640) == probe_gemv.plan_gemv("native_int4", 1024,
                                                                              640)
    packed = probe_gemv.plan_gemv("packed_int8", 768, 3072)
    assert (packed.tiles, packed.splits, packed.ctas, packed.packed) == (48, 3, 144, True)


@pytest.mark.parametrize("K", [256, 512, 768, 1024])
@pytest.mark.parametrize("fmt", probe_gemv.FORMATS)
def test_plan_covers_every_accepted_shape(fmt, K):
    """Every (K, N) the wrapper takes has a plan: splits of whole mma steps
    (of packed byte rows for packed_int8) that tile K, at most 8: the most,
    at most 4, that leave a CTA 128 rows (2 at K 256, 4 above; packed_int8
    256 rows and at least 2: 2, 2, 3, 4), whatever N (N = 64: one tile,
    below 132 CTAs)."""
    packed = fmt == "packed_int8"
    want = ({256: 2, 512: 2, 768: 3, 1024: 4} if packed else {256: 2, 512: 4, 768: 4, 1024: 4})[K]
    min_rows = probe_gemv.PACKED_MIN_ROWS if packed else probe_gemv.MIN_ROWS
    for N in list(range(64, 8192 + 1, 64)) + [16896, 65536]:
        plan = probe_gemv.plan_gemv(fmt, K, N)
        assert plan.tiles * plan.tile == N and plan.splits * plan.kchunk == K
        assert plan.kchunk % probe_gemv.STEP == 0 and 1 <= plan.splits <= probe_gemv.MAX_CLUSTER
        assert plan.steps(K) % plan.splits == 0
        assert plan.splits == want and (plan.kchunk >= min_rows or plan.splits == 2)
        more = [s for s in range(plan.splits + 1, probe_gemv.PLAN_SPLITS + 1)
                if plan.steps(K) % s == 0]
        assert all(K // s < min_rows for s in more)
    small = probe_gemv.plan_gemv(fmt, K, 64)
    assert (small.splits, small.ctas) == (want, want) and small.ctas < SMS


@pytest.mark.parametrize("K,splits", [(256, 2), (512, 2), (768, 3), (1024, 4)])
def test_packed_plan_at_every_width(K, splits):
    """packed_int8 at K 256-1024: its rule's split (K / 256, at least 2),
    each CTA K / S rows as K / 2S byte rows, whole mma steps of byte rows,
    48 x S CTAs at N 3072, 144 at K 768."""
    plan = probe_gemv.plan_gemv("packed_int8", K, 3072)
    assert (plan.splits, plan.kchunk, plan.ctas, plan.packed) == (splits, K // splits,
                                                                   48 * splits, True)
    assert plan.steps(K) == K // 2 // probe_gemv.STEP and plan.steps(K) % splits == 0
    assert (plan.kchunk // 2) % probe_gemv.STEP == 0


@pytest.mark.parametrize("K,splits", [(K, s) for K in (256, 512, 1024) for s in (1, 2, 4, 8)]
                         + [(768, s) for s in (1, 2, 3, 4, 6, 8)])
def test_packed_bounds_own_each_byte_row_once(K, splits):
    """Every split the kernel takes: each byte row of the [K / 2, N] storage
    belongs to exactly one split, whose two ranges are that byte row's low-
    and high-nibble K rows (r and r + K / 2): every K row read once."""
    base = probe_gemv.plan_gemv("packed_int8", K, 64)
    assert base.steps(K) % splits == 0
    plan = dataclasses.replace(base, splits=splits, kchunk=K // splits)
    owner = np.zeros(K // 2, np.int64)
    rows = np.zeros(K, np.int64)
    for lo, hi in plan.bounds():
        assert lo[1] - lo[0] == hi[1] - hi[0] == K // splits // 2
        assert hi[0] == lo[0] + K // 2 and (lo[1] - lo[0]) % probe_gemv.STEP == 0
        owner[lo[0]:lo[1]] += 1
        rows[lo[0]:lo[1]] += 1
        rows[hi[0]:hi[1]] += 1
    assert (owner == 1).all() and (rows == 1).all()


def test_plan_rejects_shapes_the_wrapper_refuses():
    for K, N in ((128, 3072), (640, 3072), (1280, 3072), (768, 96), (768, 0)):
        with pytest.raises(ValueError):
            probe_gemv.plan_gemv("bf16", K, N)
    with pytest.raises(ValueError):
        probe_gemv.plan_gemv("int3", 768, 3072)


def test_kernel_constants_mirror_the_plan():
    """csrc/probe_gemv.cu's plan_splits reads the same constants as
    plan_gemv: tile, mma step, largest cluster, the plan's most splits and
    fewest rows a CTA, stamps."""
    src = SOURCE.read_text()
    const = lambda name: re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    assert int(const("kTile")) == probe_gemv.TILE
    assert int(const("kStep")) == probe_gemv.STEP
    assert int(const("kMaxCluster")) == probe_gemv.MAX_CLUSTER
    assert int(const("kPlanSplits")) == probe_gemv.PLAN_SPLITS
    assert int(const("kMinRows")) == probe_gemv.MIN_ROWS
    assert int(const("kPackedMinRows")) == probe_gemv.PACKED_MIN_ROWS
    assert int(const("kPackedMinSplits")) == probe_gemv.PACKED_MIN_SPLITS
    assert int(const("kGemvStamps")) == probe_gemv.STAMPS
    assert "cudaLaunchAttributeClusterDimension" in src and "atomicAdd" not in src
    assert "gemv_packed_kernel" not in src
    assert re.search(r"magpie_probe_gemv_packed_int8\([^}]*gemv_split<kPackedInt8>", src)


@pytest.mark.parametrize("fmt", probe_gemv.FORMATS)
def test_split_model_matches_plain_and_jax(fmt):
    """The model of the kernels' sum order on the probe's inputs against the
    plain version and the JAX probe's outputs (interpret mode)."""
    outs, _ = jax_gemv_outputs()
    x, w, _, _ = probe_int4.make_inputs(CPU)[fmt]
    got = probe_gemv.split_model(x, w, fmt)
    assert _close(fmt, got, probe_gemv.gemv_reference(x, w, fmt))
    assert _close(fmt, got, torch.from_numpy(outs[fmt]))


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("fmt", probe_gemv.FORMATS)
def test_split_model_over_every_split(fmt, splits):
    """Every split of K = 768 the kernels take: the model against plain on
    random inputs (small-integer x for int4: bit-equal; normal x for bf16)."""
    rng = np.random.default_rng(splits)
    if fmt == "bf16":
        w = torch.from_numpy(rng.standard_normal((768, 192))).to(torch.bfloat16)
        x = torch.from_numpy(rng.standard_normal((8, 768))).to(torch.bfloat16)
    else:
        pack = probe_gemv.pack_int8 if fmt == "packed_int8" else probe_gemv.pack_native_int4
        w = torch.from_numpy(pack(rng.integers(-8, 8, size=(768, 192))))
        x = torch.from_numpy(rng.integers(-3, 4, size=(8, 768)).astype(np.float32)).to(
            torch.bfloat16)
    plan = dataclasses.replace(probe_gemv.plan_gemv(fmt, 768, 192), splits=splits,
                               kchunk=768 // splits)
    got = probe_gemv.split_model(x, w, fmt, plan)
    assert _close(fmt, got, probe_gemv.gemv_reference(x, w, fmt))


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("K", [256, 1024])
def test_packed_split_model_against_plain_and_the_jax_packing(K, splits):
    """packed_int8 at the other widths: the model of every split the kernel
    takes bit-equal to plain on small-integer x, and on the weight packed as
    scripts/probe_int4.py packs it (``(w[half:] & 15) << 4 | (w[:half] &
    15)``) the same values as the exact integer product."""
    rng = np.random.default_rng(K + splits)
    wint = rng.integers(-8, 8, size=(K, 128))
    half = K // 2
    w = torch.from_numpy(((wint[half:] & 15) << 4 | (wint[:half] & 15)).astype(np.int8))
    x = torch.from_numpy(rng.integers(-3, 4, size=(8, K)).astype(np.float32))
    plan = dataclasses.replace(probe_gemv.plan_gemv("packed_int8", K, 128), splits=splits,
                               kchunk=K // splits)
    got = probe_gemv.split_model(x.to(torch.bfloat16), w, "packed_int8", plan)
    assert torch.equal(got, probe_gemv.gemv_reference(x.to(torch.bfloat16), w, "packed_int8"))
    assert np.array_equal(got.numpy(), x.numpy() @ wint.astype(np.float32))


def test_gemv_on_the_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches nothing;
    the stamped launch needs a card."""
    x, w, _, _ = probe_int4.make_inputs(CPU)["bf16"]
    before = probe_gemv.launches
    assert torch.equal(probe_gemv.gemv(x, w, "bf16"), probe_gemv.gemv_reference(x, w, "bf16"))
    assert probe_gemv.launches == before
    with pytest.raises(ValueError):
        probe_gemv.gemv_stamps(x, w, "bf16")


def test_read_phases_from_stamps():
    """us from the first CTA's start to the last CTA's each stamp, and the
    median CTA's from its own start."""
    t = torch.tensor([[1000, 2000, 2500, 3000, 3500],
                      [1500, 2100, 2600, 3900, 4000],
                      [1200, 2400, 2700, 3100, 3600]], dtype=torch.int64)
    ph = probe_gemv.read_phases(t)
    assert ph["ctas"] == 3 and ph["start_last_us"] == 0.5 and ph["end_last_us"] == 3.0
    assert ph["landed_median_us"] == 1.0 and ph["partials_median_us"] == 2.0


@pytest.mark.parametrize("k", [256, 1024])
def test_probe_int4_other_widths_on_the_cpu(k):
    """The probe path at K 256 / 1024 on the CPU (plain versions, host
    clock): the exact product, the plan, the main path's GEMM yardstick."""
    res = probe_int4.probe("native_int4", CPU, n_lo=1, n_hi=2, reps=1, timed_n=1, k=k)
    assert res["k"] == k and res["max_abs_err"] == 0.0 and res["bit_equal_plain"]
    assert res["plan"]["splits"] * res["plan"]["kchunk"] == k
    assert res["plan"]["splits"] == min(probe_gemv.PLAN_SPLITS, k // probe_gemv.MIN_ROWS)
    assert res["main_gemm_splits"] >= 1 and "split-K partials" in probe_int4.report(res)
    nbytes, flops = probe_int4.gemv_work(probe_int4.make_inputs(CPU, k)["bf16"][1])
    assert nbytes == k * 3072 * 2 + 8 * k * 2 + 8 * 3072 * 4 and flops == 2.0 * 8 * k * 3072
