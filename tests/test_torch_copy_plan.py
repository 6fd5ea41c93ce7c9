"""Kernels 15-17 (the copy probes) spread over the card: the launch plan
(``probe_copy.plan_copy``: a thread-block cluster of CTAs for each TPU grid
step, by the bytes the step reads), which words each CTA reads
(``probe_copy.cta_ranges``) and a CPU model of the kernel's checksums
(``probe_copy.cluster_model``: each CTA's XOR, then rank 0's XOR of the
ranks' words in rank order), held against the plain version, which
tests/test_torch_probes.py holds against the JAX probes.

Tolerances: none; XOR and the bf16 add are exact, every check is bit for bit.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.ops.kernels import probe_copy
from magpie_tts_tpu_torch.scripts import opt_slope_probe

SOURCE = Path(probe_copy.__file__).resolve().parents[2] / "csrc" / "probe_copy.cu"
X_WORDS = 32 * 768 // 2                      # the probes' [32, 768] bf16 x
CONST_WORDS = [r * c // 2 for r, c in opt_slope_probe.WSHAPES]
SLAB_WORDS = 512 * 1024 // 2                 # one step's [512, 1024] bf16 slab


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def test_plan_takes_only_the_variant_and_the_sizes():
    """plan_copy is a function of the variant and the sizes alone."""
    params = list(inspect.signature(probe_copy.plan_copy).parameters)
    assert params == ["variant", "grid_n", "x_words", "const_words", "slab_words"]
    assert probe_copy.plan_copy("constblk", 8, X_WORDS, CONST_WORDS) == probe_copy.plan_copy(
        "constblk", 8, X_WORDS, list(CONST_WORDS))
    x = torch.zeros(32, 768, dtype=torch.bfloat16)
    consts = opt_slope_probe.const_blocks("cpu")
    assert probe_copy.plan_for(x, 8, consts) == probe_copy.plan_copy("constblk", 8, X_WORDS,
                                                                      CONST_WORDS)
    with pytest.raises(ValueError):
        probe_copy.plan_copy("minimal", 8, X_WORDS, CONST_WORDS)
    with pytest.raises(ValueError):
        probe_copy.plan_copy("streamed", 8, X_WORDS)
    with pytest.raises(ValueError):
        probe_copy.plan_copy("flash", 8, X_WORDS)


@pytest.mark.parametrize("variant,grid_n,ctas", [("minimal", 1, 2), ("minimal", 8, 1),
                                                 ("minimal", 20, 1), ("constblk", 8, 8),
                                                 ("streamed", 8, 8)])
def test_plan_at_the_probe_shapes(variant, grid_n, ctas):
    """The fewest CTAs a step that read at most 32 KB each, at most 8: one
    CTA a step for the plain copies at grid 8 / 20 (6 / 2.4 KB a step), two
    at grid 1 (48 KB), 8 x 8 = 64 CTAs for the constant blocks (258 KB a
    step) and the slabs (1 MB a step). The CUDA grid is not grid_n."""
    const = CONST_WORDS if variant == "constblk" else ()
    slab = SLAB_WORDS if variant == "streamed" else 0
    plan = probe_copy.plan_copy(variant, grid_n, X_WORDS, const, slab)
    assert (plan.grid_n, plan.ctas, plan.blocks) == (grid_n, ctas, grid_n * ctas)
    assert plan.ctas <= probe_copy.MAX_CTAS
    if variant != "minimal":
        assert plan.blocks >= 64
    fewer = plan.ctas - 1
    assert fewer == 0 or plan.step_words * 4 > fewer * probe_copy.CTA_BYTES


@pytest.mark.parametrize("step_kb", [1, 31, 32, 33, 64, 255, 256, 257, 4096])
def test_plan_rule_over_sizes(step_kb):
    """CTAs = ceil(step bytes / 32 KB), between 1 and 8."""
    words = step_kb * 256
    plan = probe_copy.plan_copy("streamed", 1, 4, slab_words=words - 4)
    assert plan.step_words == words
    assert plan.ctas == min(8, max(1, -(-words * 4 // probe_copy.CTA_BYTES)))


CALLS = [  # (segment words, grid_n, slab last): the probes' calls and ragged ones
    ([X_WORDS], 1, False), ([X_WORDS], 8, False), ([X_WORDS], 20, False),
    ([X_WORDS, *CONST_WORDS], 8, False), ([X_WORDS, SLAB_WORDS], 8, True),
    ([1001, 7, 13, 4096], 3, False), ([1001], 20, False), ([10, 13], 2, True), ([6, 5], 1, True)]


@pytest.mark.parametrize("seg_words,grid_n,slab", CALLS)
def test_every_word_is_read_once_by_its_own_step(seg_words, grid_n, slab):
    """At every CTA count a launch takes (1 to 16): each word of each segment
    (x, the constant blocks, the slabs) is read by exactly one CTA, a CTA of
    the TPU grid step that owns the word; every range but rank 0's
    unaligned words (and x's words where its step share is not whole
    vectors) is whole 16-byte vectors, one range a segment."""
    for ctas in range(1, probe_copy.MAX_CLUSTER + 1):
        counts = [np.zeros(n * grid_n if slab and j == len(seg_words) - 1 else n, np.int64)
                  for j, n in enumerate(seg_words)]
        for i in range(grid_n):
            for r in range(ctas):
                reads = probe_copy.cta_reads(seg_words, grid_n, i, ctas, r, slab)
                assert len(reads) == len(seg_words)
                for j, (n, ranges) in enumerate(zip(seg_words, reads)):
                    is_slab = slab and j == len(seg_words) - 1
                    lo, hi = (i * n, (i + 1) * n) if is_slab else (i * n // grid_n,
                                                                   (i + 1) * n // grid_n)
                    if r > 0 and not (j == 0 and (lo | hi) % 4):
                        assert len(ranges) <= 1 and all(a % 4 == b % 4 == 0 for a, b in ranges)
                    for a, b in ranges:
                        assert lo <= a < b <= hi
                        counts[j][a:b] += 1
        assert all((c == 1).all() for c in counts), ctas


def test_constant_blocks_run_cut_into_few_pieces():
    """The constant blocks' shares make one run cut C - 1 times: at the
    plan's 8 CTAs a step the CTAs read 10 + 7 = 17 pieces in all, not one of
    every block each (80; the 4 KB blocks would give a CTA 4 vectors)."""
    plan = probe_copy.plan_copy("constblk", 8, X_WORDS, CONST_WORDS)
    for step in range(8):
        pieces = sum(len(ranges) for r in range(plan.ctas)
                     for ranges in probe_copy.cta_reads([X_WORDS, *CONST_WORDS], 8, step,
                                                        plan.ctas, r)[1:])
        assert pieces <= len(CONST_WORDS) + plan.ctas - 1


@pytest.mark.parametrize("variant,grid_n", [("minimal", 1), ("minimal", 8), ("minimal", 20),
                                            ("constblk", 8), ("streamed", 8), ("streamed", 3)])
def test_cluster_model_equals_the_plain_checksums(variant, grid_n):
    """Each CTA's XOR of its words, then rank 0's XOR in rank order, gives
    copy_reference's checksums bit for bit, at the plan's CTAs and at every
    count a launch takes."""
    rng = np.random.default_rng(grid_n)
    x = _bf16(rng, 32, 768)
    kw = {}
    if variant == "constblk":
        kw["consts"] = opt_slope_probe.const_blocks("cpu")
    elif variant == "streamed":
        kw["slab"] = _bf16(rng, grid_n, 64, 1024)
    _, want = probe_copy.copy_reference(x, grid_n, **kw)
    assert torch.equal(probe_copy.cluster_model(x, grid_n, **kw), want)
    for ctas in (1, 2, 3, 5, 8, 16):
        assert torch.equal(probe_copy.cluster_model(x, grid_n, ctas=ctas, **kw), want), ctas


def test_cluster_model_on_ragged_sizes():
    """Segments whose step shares start and end off 16-byte vectors (x of
    1001 words at grid 3 and 20, constant blocks of 7 and 13 words, a slab of
    odd words): the model still equals the plain checksums."""
    rng = np.random.default_rng(5)
    x = _bf16(rng, 2002)
    consts = [_bf16(rng, 14), _bf16(rng, 26), _bf16(rng, 4096)]
    for g in (3, 20):
        _, want = probe_copy.copy_reference(x, g, consts)
        for ctas in (None, 1, 4, 16):
            assert torch.equal(probe_copy.cluster_model(x, g, consts, ctas=ctas), want)
    slab = _bf16(rng, 3, 26)
    _, want = probe_copy.copy_reference(x, 3, slab=slab)
    assert torch.equal(probe_copy.cluster_model(x, 3, slab=slab, ctas=2), want)


def test_kernel_constants_mirror_the_plan():
    """csrc/probe_copy.cu's plan_ctas reads the same constants as plan_copy;
    the grid is (CTAs, grid_n), a cluster a step, and no atomics."""
    src = SOURCE.read_text()
    const = lambda name: re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    assert int(const("kThreads")) == probe_copy.THREADS
    assert int(const("kCtaBytes")) == probe_copy.CTA_BYTES
    assert int(const("kMaxCtas")) == probe_copy.MAX_CTAS
    assert int(const("kMaxCluster")) == probe_copy.MAX_CLUSTER
    assert int(const("kCopyStamps")) == probe_copy.STAMPS
    assert int(const("kMaxConst")) == probe_copy.MAX_CONST
    assert "(step_words * 4 + kCtaBytes - 1) / kCtaBytes" in src
    assert "dim3(ctas, grid_n)" in src and "cudaLaunchAttributeClusterDimension" in src
    assert "atomicAdd" not in src and "atom." not in src


def test_copy_on_the_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; the stamped launch needs a card."""
    x = torch.zeros(32, 768, dtype=torch.bfloat16)
    before = probe_copy.launches
    out, cs = probe_copy.copy(x, 8)
    want_out, want_cs = probe_copy.copy_reference(x, 8)
    assert torch.equal(out, want_out) and torch.equal(cs, want_cs)
    assert probe_copy.launches == before
    with pytest.raises(ValueError):
        probe_copy.copy_stamps(x, 8)


def test_read_phases_from_stamps():
    t = torch.tensor([[1000, 1500, 2000, 2500, 3000],
                      [1200, 1400, 2600, 2700, 2800]], dtype=torch.int64)
    ph = probe_copy.read_phases(t)
    assert ph["ctas"] == 2 and ph["start_last_us"] == 0.2 and ph["end_last_us"] == 2.0
    assert ph["read_median_us"] == 1.0  # the lower middle of two
