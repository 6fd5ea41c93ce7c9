"""Kernel B (csrc/codec_conv.cu) and kernel 9 (csrc/codec_res_fused.cu) on
the tensor cores.

On the CPU: a plain model of the float32 kernels' split-TF32 products
(summed in kernel B's (chunk, tap) order, with the tensor cores' products of
8 channels and a sum per ring step) held against the float32 plain version at
the smoke's bars and against a float64 conv, at the production widths of
each stage; a model of the bf16 sums (truncating, chained against from
zero); the Python launch plan of every conv class of ``CodecConfig()``
(shared memory, padding, K order, the SMs filled), the plans the sweep
script times, and kernel 9's warp split.

On the card (marker ``cuda``; they skip here): kernel B against its plain
version for every production class in both dtypes, at a T that is no
multiple of the tile and N = 3, and each row of B and of kernel 9 bit-equal
wherever its tile starts (the streaming path's invariance):
    MAGPIE_TEST_TPU=1 python -m pytest tests/test_torch_codec_conv.py -q -m cuda
This file imports neither jax nor the JAX package.
"""

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.config import CodecConfig
from magpie_tts_tpu_torch.io.codec_weights import random_codec_weights
from magpie_tts_tpu_torch.models.codec import half_snake
from magpie_tts_tpu_torch.ops.kernels import codec_conv as cc
from magpie_tts_tpu_torch.ops.kernels import codec_res_fused as crf

CFG = CodecConfig()
BF = torch.bfloat16
CONV_ATOL, CONV_RTOL = 1e-4, 1e-5  # chip_smoke.py's bars for kernel B in float32
H100_SMEM, H100_SMS = 232448, 132
RATES = np.cumprod(CFG.up_sample_rates)  # rows per frame after each stage: 8 ... 1024


def _classes():
    """(name, C_in, C_out, k, dilation, residual, activation, rows per frame)
    of every conv class of a decode: the pre-conv, each stage's in-convs (k x
    dilation) and sk-convs (with the residual), the post-conv."""
    out = [("pre", CFG.latent_dim, CFG.base_channels, CFG.pre_conv_kernel, 1, False, False, 1)]
    for s, (C, rate) in enumerate(zip(CFG.up_channels, RATES)):
        for k in CFG.resblock_kernel_sizes:
            for d in CFG.resblock_dilations:
                out.append((f"s{s}.in.k{k}.d{d}", C, C, k, d, False, True, int(rate)))
            out.append((f"s{s}.sk.k{k}", C, C, k, 1, True, True, int(rate)))
    out.append(("post", CFG.up_channels[-1], 1, CFG.post_conv_kernel, 1, False, True,
                int(RATES[-1])))
    return out


CLASSES = _classes()


# ------------------------------------------------ the split-TF32 model (CPU)

def _tf32(v: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero: cvt.rna.tf32.f32."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(v: torch.Tensor):
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def split_tf32_conv(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dilation: int,
                    residual=None) -> torch.Tensor:
    """Kernel B's float32 arithmetic on an activated input h [T, C_in]: the
    float32 K order of ``cc.k_order`` (chunks of ``chunk_width`` channels, tap by tap
    inside a chunk), the three tensor-core products of each 8 channels (lo*hi,
    hi*lo, hi*hi; each a float32 sum of 8 exact products) summed from zero,
    added to the ring step's sum, each step's sum added to the total, then +
    bias (+ residual) in float32."""
    k, c_in, c_out = w.shape
    T = h.shape[0]
    hp = torch.cat([torch.zeros((k - 1) * dilation, c_in), h])
    total = torch.zeros(T, c_out)
    kc = cc.chunk_width(c_in, torch.float32)
    for c0, tap in cc.k_order(c_in, k, torch.float32):
        part = torch.zeros(T, c_out)
        a = hp[tap * dilation:tap * dilation + T]
        for k0 in range(c0, min(c0 + kc, c_in), 8):
            a_hi, a_lo = _split(a[:, k0:k0 + 8])
            b_hi, b_lo = _split(w[tap, k0:k0 + 8])
            d = torch.zeros(T, c_out)
            for pa, pb in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                d = (d.double() + pa.double() @ pb.double()).float()
            part = part + d
        total = total + part
    out = total + b
    return out if residual is None else out + residual


def _stage_case(cls, T, seed):
    name, c_in, c_out, k, d, res, act, _ = cls
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(0, 0.5, size=(T, c_in)), dtype=torch.float32)
    w = torch.tensor(rng.normal(0, 0.1, size=(k, c_in, c_out)), dtype=torch.float32)
    b = torch.tensor(rng.normal(0, 0.1, size=c_out), dtype=torch.float32)
    alpha = (torch.tensor(0.5 + rng.uniform(0.1, 1.0, size=c_in // 2), dtype=torch.float32)
             if act else None)
    r = torch.tensor(rng.normal(0, 0.5, size=(T, c_out)), dtype=torch.float32) if res else None
    return x, w, b, alpha, d, r


# One class per stage at its production widths (the widest k and dilation),
# the pre- and post-conv; short T.
MODEL_CLASSES = [c for c in CLASSES if c[0] in ("pre", "post") or c[0].endswith(".in.k11.d5")]


@pytest.mark.parametrize("cls", MODEL_CLASSES, ids=[c[0] for c in MODEL_CLASSES])
def test_split_tf32_model_holds_the_float32_bar(cls):
    """The float32 kernel's split-TF32 products, modelled in PyTorch, stay
    within CONV_ATOL / CONV_RTOL of the float32 plain version, and no
    further from a float64 conv than 1/10 of that bar."""
    x, w, b, alpha, d, r = _stage_case(cls, 40, seed=len(cls[0]) + cls[1])
    h = x if alpha is None else half_snake(x, alpha, CFG.leaky_slope)
    model = split_tf32_conv(h, w, b, d, r)
    plain = cc.snake_causal_conv_reference(x, w, b, alpha, d, CFG.leaky_slope, r)
    hp = torch.nn.functional.pad(h.double().T[None], ((w.shape[0] - 1) * d, 0))
    exact = torch.nn.functional.conv1d(hp, w.double().permute(2, 1, 0), dilation=d)[0].T
    exact = exact + b.double() + (0 if r is None else r.double())
    assert torch.allclose(model, plain, atol=CONV_ATOL, rtol=CONV_RTOL)
    err_model = float((model.double() - exact).abs().max())
    err_plain = float((plain.double() - exact).abs().max())
    assert err_model <= CONV_ATOL / 10, (err_model, err_plain)


def test_split_tf32_model_keeps_more_than_tf32():
    """One TF32 pass would miss the bar that split TF32 holds (the reason
    TF32 stays off): the hi*hi product alone is ~1e-3 off at C = 432."""
    cls = next(c for c in CLASSES if c[0] == "s0.in.k11.d5")
    x, w, b, alpha, d, r = _stage_case(cls, 24, seed=5)
    h = half_snake(x, alpha, CFG.leaky_slope)
    plain = cc.snake_causal_conv_reference(x, w, b, alpha, d, CFG.leaky_slope, r)
    single = cc.snake_causal_conv_reference(_tf32(h), _tf32(w), b, None, d, 0.01, r)
    assert not torch.allclose(single, plain, atol=CONV_ATOL, rtol=CONV_RTOL)
    assert torch.allclose(split_tf32_conv(h, w, b, d, r), plain, atol=CONV_ATOL, rtol=CONV_RTOL)


# ------------------------------------- the bf16 sums from zero, a model (CPU)

def _rz32(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, toward zero (the tensor cores' float32 sums)."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def bf16_mma_conv(h: torch.Tensor, w: torch.Tensor, dilation: int, chained: bool):
    """Kernel B's bf16 products in its K order, each mma's 16 channels an
    exact sum truncated to float32: ``chained`` adds the running total inside
    the mma (truncated with it), else the mma sums from zero and a float add
    (to nearest) carries it into the total, as conv_mma.cuh does."""
    k, c_in, c_out = w.shape
    T = h.shape[0]
    hp = torch.cat([torch.zeros((k - 1) * dilation, c_in), h])
    total = torch.zeros(T, c_out)
    kc = cc.chunk_width(c_in, BF)
    for c0, tap in cc.k_order(c_in, k, BF):
        a = hp[tap * dilation:tap * dilation + T]
        for k0 in range(c0, min(c0 + kc, c_in), 16):
            prod = a[:, k0:k0 + 16].double() @ w[tap, k0:k0 + 16].double()
            total = _rz32(total.double() + prod) if chained else total + _rz32(prod)
    return total


@pytest.mark.parametrize("width", [(432, 11, 64), (216, 7, 64), (108, 11, 128), (27, 11, 256)],
                         ids=["s0", "s1", "s2", "s4"])
def test_bf16_sums_from_zero_carry_no_truncation_bias(width):
    """Truncating sums chained through the K loop drift toward zero (the
    mean signed error against a float64 conv is many float32 ulps); summed
    from zero per mma and carried by rounding adds, the drift is gone to a
    tenth or less. Units: float32 ulps of max(|value|, its row's RMS)."""
    c, k, T = width
    rng = np.random.default_rng(c)
    h = torch.tensor(rng.normal(0, 0.5, (T, c)), dtype=torch.float32).to(BF).float()
    w = torch.tensor(rng.normal(0, 0.1, (k, c, c)), dtype=torch.float32).to(BF).float()
    hp = torch.nn.functional.pad(h.double().T[None], ((k - 1) * 5, 0))
    exact = torch.nn.functional.conv1d(hp, w.double().permute(2, 1, 0), dilation=5)[0].T
    ref = torch.maximum(exact.abs(), exact.pow(2).mean(-1, keepdim=True).sqrt())
    ulp = torch.exp2(torch.floor(torch.log2(ref)) - 23)
    bias = {}
    for chained in (True, False):
        e = (bf16_mma_conv(h, w, 5, chained).double() - exact) * exact.sign() / ulp
        bias[chained] = (float(e.mean()), float(e.std()) / e.numel() ** 0.5)
    assert bias[True][0] < -1.0 and bias[True][0] < -10 * bias[True][1], bias
    assert abs(bias[False][0]) < abs(bias[True][0]) / 10, bias


# --------------------------------------------------- the launch plan (CPU)

FRAMES = (1, 4, 32, 36)  # a short utterance .. a 32-frame decode, a stream's 36-frame window


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("stage", ["pre", "s0", "s1", "s2", "s3", "s4", "post"])
def test_launch_plan_of_every_class(stage, dtype):
    """For every conv class of the stage, every T from 1 to 36 frames and
    N = 1 and 3: the plan fits a block's shared memory, shapes the output
    tile as warps x n8 tiles the kernel instantiates, covers every row and
    channel, and fills the 132 SMs wherever the finest tiles could; its K
    order is the same for every T, N and dtype."""
    for name, c_in, c_out, k, d, res, act, rate in CLASSES:
        if name.split(".")[0] != stage:
            continue
        for frames in FRAMES:
            for n in (1, 3):
                T = frames * rate
                p = cc.plan_conv(n, T, c_in, c_out, k, d, dtype, H100_SMS, act=act)
                assert p.smem == cc.smem_bytes(p.tile_m, p.tile_n, k, d, dtype, p.kc) <= H100_SMEM
                assert p.kc == cc.chunk_width(c_in, dtype)
                assert p.tile_m in cc.TILES_M
                warps_n = cc.WARPS // (p.tile_m // cc.WARP_ROWS)
                assert p.tile_n // (8 * warps_n) in cc.WARP_NTS[dtype]
                assert p.tile_n % (8 * warps_n) == 0
                assert p.grid[0] * p.tile_m >= T and p.grid[1] * p.tile_n >= c_out
                assert (p.grid[0] - 1) * p.tile_m < T and (p.grid[1] - 1) * p.tile_n < c_out
                assert p.grid[2] == n
                # the most blocks any shape gives: one n8 tile a warp
                finest = max(n * -(-T // tm) * -(-c_out // (cc.WARPS // (tm // 32) * 8))
                             for tm in cc.TILES_M)
                if finest >= H100_SMS:
                    assert p.blocks >= H100_SMS, (name, T, n, p)


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
def test_launch_plans_hold_the_pick(dtype):
    """Every plan of ``conv_plans`` is one the kernel takes, and the pick is
    one of them, for every class of a 32-frame decode."""
    for name, c_in, c_out, k, d, res, act, rate in CLASSES:
        T = 32 * rate
        plans = [p for _, p in cc.conv_plans(1, T, c_in, c_out, k, d, dtype, H100_SMS, act)]
        assert len(set(plans)) == len(plans) > 0
        for p in plans:
            assert p.smem == cc.smem_bytes(p.tile_m, p.tile_n, k, d, dtype, p.kc) <= H100_SMEM
            assert p.tile_n % (8 * (cc.WARPS // (p.tile_m // cc.WARP_ROWS))) == 0
        assert cc.plan_conv(1, T, c_in, c_out, k, d, dtype, H100_SMS, act=act) in plans


def test_conv_plan_sweep_lists_the_plans_on_the_cpu(capsys):
    """scripts/conv_plan_sweep.py with --device cpu: every class of the
    decode with its pick among the plans, in one JSON line, no times."""
    import json

    from magpie_tts_tpu_torch.scripts import conv_plan_sweep

    assert conv_plan_sweep.main(["--device", "cpu", "--frames", "4", "--dtype", "bfloat16"]) == 0
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["classes"]
    assert [r["class"] for r in rows] == ["pre"] + [f"s{s}.k{k}" for s in range(5)
                                                     for k in (3, 7, 11)] + ["post"]
    for r in rows:
        assert r["pick"] in r["plans"] and "pick_ms" not in r


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
def test_fused_warp_split_covers_the_channels(dtype):
    """Kernel 9's warp split, computed here and checked by the kernel: warps
    side by side dividing the 8, n8 tiles a warp holds in ``dtype``, the
    narrowest cover of C, then the most rows a pass; its shared memory
    follows the dtype, which the caller must name."""
    for C in range(1, crf.MAX_CHANNELS + 1):
        wn, nt = crf.warp_split(C, dtype)
        assert cc.WARPS % wn == 0 and nt in cc.WARP_NTS[dtype] and wn * nt * 8 >= C
        assert all(a * b >= wn * nt for a in (1, 2, 4, 8) for b in cc.WARP_NTS[dtype]
                   if a * b * 8 >= C)
        assert crf.pass_rows(C, dtype) == cc.WARPS // wn * cc.WARP_ROWS
    assert crf.warp_split(108, dtype) == ((2, 7) if dtype == BF else (4, 4))
    with pytest.raises(TypeError):
        crf.smem_bytes(64, 120, 108)


def test_launch_plan_strides_avoid_bank_conflicts():
    """Window rows are odd multiples of 16 bytes (ldmatrix's 8 rows in 8
    bank groups); weight rows are 8 mod 16 elements (conflict-free B loads)."""
    for dtype, elt in ((torch.float32, 4), (BF, 2)):
        for cols in (32, 64, 128, 27, 54, 108):
            stride = cc.window_stride(cols, dtype) * elt
            assert stride % 16 == 0 and (stride // 16) % 2 == 1
            assert cc.window_stride(cols, dtype) >= cols
    for tile_n in range(8, 257, 8):
        assert cc.ring_stride(tile_n) % 16 == 8 and cc.ring_stride(tile_n) >= tile_n


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
def test_fused_tile_fits_in_the_operand_type(dtype):
    """Kernel 9's windows in the operand type: bf16 takes tiles of 128 to 256
    rows at C = 108 where float32 stops at 64, and every picked tile fits."""
    cw = random_codec_weights(CFG, seed=0).to(dtype=dtype)
    from magpie_tts_tpu_torch.models.codec import fused_layers
    layers = fused_layers(cw, CFG)[2:]
    fits = [t for t in crf._TILES if crf._fits(t, layers[0])]
    assert max(fits) == (256 if dtype == BF else 64)
    for T, la in zip((8192, 16384, 32768), layers):
        for n in (1, 3):
            t = crf.pick_tile(n, T, la, H100_SMS)
            assert crf.smem_bytes(t, la.halo, la.channels, dtype) <= H100_SMEM


# ------------------------------------------------------- on the card (cuda)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    from magpie_tts_tpu_torch.runtime import engine as engine_mod
    return engine_mod.resolve_device("cuda")


def _scaled_ulps(got, want):
    g, w = got.float(), want.float()
    ref = torch.maximum(w.abs(), w.pow(2).mean(-1, keepdim=True).sqrt()).clamp_min(1e-30)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(ref)) - 7)


def _card_case(cls, dev, dtype, n, T, seed):
    name, c_in, c_out, k, d, res, act, _ = cls
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=0.5: torch.tensor(rng.normal(0, s, shape), dtype=torch.float32,
                                          device=dev).to(dtype)
    x, w, b = f(n, T, c_in), f(k, c_in, c_out, s=0.1), f(c_out, s=0.1)
    alpha = (torch.tensor(0.5 + rng.uniform(0.1, 1.0, c_in // 2), dtype=torch.float32,
                          device=dev).to(dtype) if act else None)
    r = f(n, T, c_out) if res else None
    return x, w, b, alpha, d, r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("cls", CLASSES, ids=[c[0] for c in CLASSES])
def test_conv_kernel_matches_plain_every_class(cuda, cls, dtype):
    """Every production class at N = 3 and a T of 4 frames + 13 rows (no
    multiple of any tile): float32 within CONV_ATOL / CONV_RTOL, bf16 every
    value within 1 scaled ulp."""
    T = 4 * cls[7] + 13
    x, w, b, alpha, d, r = _card_case(cls, cuda, dtype, 3, T, seed=T + cls[1])
    cc.launches = 0
    got = cc.snake_causal_conv(x, w, b, alpha, d, CFG.leaky_slope, residual=r)
    want = cc.snake_causal_conv_reference(x, w, b, alpha, d, CFG.leaky_slope, r)
    torch.cuda.synchronize()
    assert cc.launches == 1 and got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        assert torch.allclose(got, want, atol=CONV_ATOL, rtol=CONV_RTOL), \
            float((got - want).abs().max())
    else:
        u = _scaled_ulps(got, want) if cls[2] > 1 else _scaled_ulps(got.flatten(),
                                                                    want.flatten())
        assert float(u.max()) <= 1.0


INVARIANT = [c for c in CLASSES if c[0] in ("pre", "s0.in.k11.d5", "s1.sk.k7", "s2.in.k7.d3",
                                            "s3.in.k3.d1", "s4.sk.k11", "post")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("cls", INVARIANT, ids=[c[0] for c in INVARIANT])
def test_conv_rows_do_not_depend_on_the_tile(cuda, cls, dtype):
    """conv(x[:, a:]) equals conv(x)[:, a:] bit for bit on every row past the
    halo, for offsets a that move the tiles, T and with it the plan."""
    T = 36 * cls[7] if cls[7] < 512 else 4 * cls[7] + 77
    x, w, b, alpha, d, r = _card_case(cls, cuda, dtype, 1, T, seed=T)
    halo = (w.shape[0] - 1) * d
    full = cc.snake_causal_conv(x, w, b, alpha, d, CFG.leaky_slope, residual=r)
    for a in (1, 7, 33, 100):
        part = cc.snake_causal_conv(x[:, a:].contiguous(), w, b, alpha, d, CFG.leaky_slope,
                                    residual=None if r is None else r[:, a:].contiguous())
        assert torch.equal(part[:, halo:], full[:, a + halo:]), (a, cls[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("stage", [2, 3, 4])
def test_res_layer_rows_do_not_depend_on_the_tile(cuda, stage, dtype):
    """Kernel 9: res_layer_fused(x[:, a:]) equals res_layer_fused(x)[:, a:]
    bit for bit past the layer's halo, and so does any other tile."""
    from magpie_tts_tpu_torch.models.codec import fused_layers
    layer = fused_layers(random_codec_weights(CFG, seed=3).to(device=cuda, dtype=dtype),
                         CFG)[stage]
    T = 700 + 37 * stage
    rng = np.random.default_rng(T)
    x = torch.tensor(rng.normal(0, 0.5, (1, T, layer.channels)), dtype=torch.float32,
                     device=cuda).to(dtype)
    full = crf.res_layer_fused(x, layer)
    for a in (1, 7, 33, 100):
        part = crf.res_layer_fused(x[:, a:].contiguous(), layer)
        assert torch.equal(part[:, layer.halo:], full[:, a + layer.halo:]), a
    for tile in (8, 32):
        assert torch.equal(crf.res_layer_fused(x, layer, tile=tile), full)
