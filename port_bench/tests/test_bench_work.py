"""Operations and bytes at known shapes."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from port_bench import run, spec, work

PEAKS = run.PEAKS


def hp_357m():
    from magpie_tts_tpu_torch.config import CodecConfig, MagpieConfig

    return dataclasses.asdict(MagpieConfig()), dataclasses.asdict(CodecConfig())


def test_decoder_and_lt_products_357m():
    hp, _ = hp_357m()
    per_layer = 3 * 768 * 768 + 768 * 768 + 768 * 128 + 128 * 768 + 2 * 768 * 3072
    assert work.decoder_matmul_params(hp) == 12 * per_layer == 87_293_952
    lt = 8 * 768 * 256 + 8 * (3 * 256 * 256 + 256 * 256 + 2 * 256 * 1024 + 256 * 2024)
    assert work.lt_matmul_params(hp) == lt
    assert work.frame_matmul_flops(hp) == 2.0 * (87_293_952 + lt)
    assert work.attention_flops(hp, 300, 40) == 4.0 * 12 * (300 * 768 + 40 * 128)


def test_codec_flops_per_frame_357m():
    _, chp = hp_357m()
    res = 0.0
    steps, cin = 1, 864
    for rate, cout, kup in zip((8, 8, 4, 2, 2), (432, 216, 108, 54, 27), (16, 16, 8, 4, 4)):
        res += 2.0 * cin * kup * steps
        steps *= rate
        res += steps * 3 * sum(4.0 * k * cout * cout for k in (3, 7, 11))
        cin = cout
    expect = 2.0 * 7 * 32 * 864 + res + steps * 2.0 * 3 * 27
    assert steps == 1024
    assert work.codec_flops_per_frame(chp) == pytest.approx(expect)
    assert 2.4e9 < expect < 2.6e9


def test_kernel_b_least_time():
    b = spec.module("rooflines", "B")
    x = torch.zeros(2, 5, 8, dtype=torch.bfloat16)
    w = torch.zeros(3, 8, 16, dtype=torch.bfloat16)
    info = b.info(x, w, torch.zeros(16), torch.zeros(4, dtype=torch.bfloat16), 1, 0.01,
                  residual=torch.zeros(2, 5, 16))
    assert info == {"elt": 2, "nt": 10, "k": 3, "cin": 8, "cout": 16, "residual": True, "alpha": 4}
    least = b.least_seconds([info], {}, PEAKS, "bfloat16")
    flops = 2 * 3 * 8 * 16 * 10
    nbytes = 2 * (10 * 8 + 3 * 8 * 16 + 16 + 4 + 2 * 10 * 16)
    assert least == pytest.approx(max(flops / 989e12, nbytes / 3.35e12))


def test_kernel_a_and_c_agree_on_one_slot():
    """Kernel C with one live slot whose mask holds rows 0..pos-1 reads what
    kernel A reads at pos, apart from C's position row."""
    hp, _ = hp_357m()
    a, c = spec.module("rooflines", "A"), spec.module("rooflines", "C")
    pos, enc = 300, 40
    ia = a.info(torch.zeros(768), pos, torch.zeros(12, 64, 128), enc_length=enc)
    assert ia == {"elt": 4, "rows": pos + 1, "xa_rows": enc}
    valid = torch.zeros(1, 640, dtype=torch.bool)
    valid[0, :pos] = True
    ic = c.info(torch.zeros(1, 768), pos, valid, torch.ones(1, dtype=torch.bool), None, None,
                None, None, None, None, None, torch.tensor([enc], dtype=torch.int32))
    la = a.least_seconds([ia], hp, PEAKS, "float32")
    lc = c.least_seconds([ic], hp, PEAKS, "float32")
    assert lc == pytest.approx(la + 4 * 768 / 3.35e12)
    weights = work.frame_weight_elements(hp)
    assert la == pytest.approx(4 * (weights + work.kv_elements(hp, pos + 1)
                                    + work.xa_elements(hp, enc) + 8 * 768 + 2 * 768) / 3.35e12)


def test_kernel_c_counts_only_slots_that_go_on():
    hp, _ = hp_357m()
    c = spec.module("rooflines", "C")
    valid = torch.ones(4, 640, dtype=torch.bool)
    go = torch.tensor([True, False, True, False])
    enc = torch.tensor([10, 20, 30, 40], dtype=torch.int32)
    info = c.info(torch.zeros(4, 768, dtype=torch.bfloat16), 5, valid, go, None, None, None,
                  None, None, None, None, enc)
    assert int(info["kv_rows"]) == 2 * 640 and int(info["xa_rows"]) == 40 and int(info["live"]) == 2
