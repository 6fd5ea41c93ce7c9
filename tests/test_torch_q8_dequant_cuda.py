"""Kernel 10 (csrc/q8_dequant.cu) on the card.

Each test needs a CUDA device and skips without one; the file imports neither
jax nor the JAX package:
    MAGPIE_TEST_TPU=1 python -m pytest tests/test_torch_q8_dequant_cuda.py -q -m cuda

Bit for bit against the plain version, in float32 and bf16 (bf16 also equal
to the float32 dequant rounded to nearest even): every block-stored tensor
shape of the 357M checkpoint (the 16-byte loads and stores), stacked slices,
and the shapes that take the kernel's byte loads (rows that are not whole
16-byte runs) and one-value stores (an a extent that is not a whole number of
16-byte stores).
"""

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.config import MagpieConfig
from magpie_tts_tpu_torch.ops.kernels import q8_dequant
from magpie_tts_tpu_torch.runtime import engine as engine_mod

pytestmark = pytest.mark.cuda

BF = torch.bfloat16


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return engine_mod.resolve_device("cuda")


def _shapes_357m():
    c = MagpieConfig()
    D, F, k, X, LT, LF, V = (c.d_model, c.d_ffn, c.enc_kernel, c.d_xa, c.lt_dim, c.lt_ffn_dim,
                             c.vocab_per_cb)
    return [((3 * D, D), "linear", (2,)), ((D, D), "linear", ()), ((F, D, k), "conv_ffn", (2,)),
            ((D, F, k), "conv_ffn", ()), ((X, D), "linear", ()), ((2 * X, D), "linear", ()),
            ((D, X), "linear", ()), ((F, D, 1), "conv1", (2,)), ((D, F, 1), "conv1", ()),
            ((c.num_codebooks * V, D), "linear", ()), ((LT, D), "linear", ()),
            ((3 * LT, LT), "linear", ()), ((LF, LT, 1), "conv1", ()), ((LT, LF, 1), "conv1", ()),
            ((V, LT), "linear", (8,))]


NARROW = [((42, 64), "linear", ()), ((44, 40, 3), "conv_ffn", (2,)), ((64, 40, 3), "conv_ffn", ()),
          ((130, 96), "linear", (3,)), ((40, 72), "linear", ())]


@pytest.mark.parametrize("torch_shape,transform,lead", _shapes_357m() + NARROW)
def test_kernel_bit_equal_to_plain_in_both_dtypes(card, torch_shape, transform, lead):
    rng = np.random.default_rng(sum(torch_shape) + len(lead))
    n_blocks = int(np.prod(torch_shape)) // q8_dequant.QK
    q = torch.tensor(rng.integers(-127, 128, (*lead, n_blocks, 32)), dtype=torch.int8,
                     device=card)
    s = torch.tensor(rng.normal(0, 0.01, (*lead, n_blocks, 1)).astype(np.float16),
                     dtype=torch.float32, device=card)
    q8_dequant.launches = 0
    f32 = q8_dequant.dequantize(q, s, torch_shape, transform)
    bf = q8_dequant.dequantize(q, s, torch_shape, transform, BF)
    torch.cuda.synchronize()
    assert q8_dequant.launches == 2
    assert torch.equal(f32, q8_dequant.dequantize_reference(q, s, torch_shape, transform))
    assert torch.equal(bf, q8_dequant.dequantize_reference(q, s, torch_shape, transform, BF))
    assert torch.equal(bf, f32.to(BF))
