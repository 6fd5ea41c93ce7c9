"""Kernel 10's tiling (csrc/q8_dequant.cu), modelled on the CPU.

The kernel cannot run here; ``q8_dequant.tiled_model`` follows its loops
(one block a 64 x 64 (a, b) tile for all Kk, each thread's 16-byte loads of
the tile's rows with one block scale a load, the [a][b * Kk + kk] tile, the
16-byte stores along a, and the byte / one-value forms for shapes whose rows
are not whole 16-byte runs). Held here: on every block-stored tensor of the
357M checkpoint (the loader's Q8_0 allowlist, io/magpie_weights.py), for
all three transforms and both output dtypes, every source byte is read once,
every output element written once, and the result equals the plain version
(``dequantize_reference``) bit for bit. The allowlist's shapes are checked
against the loader on a tiny Q8_0 file. The card's own bits are held in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.config import MagpieConfig
from magpie_tts_tpu_torch.io.magpie_weights import load_magpie_weights, q8_blocks
from magpie_tts_tpu_torch.ops.kernels import q8_dequant
from tests import fixtures
from tests.utils import tiny_magpie_config

DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


def allowlist(c) -> dict:
    """{field path: (torch_shape, transform, lead)} of the block-stored
    tensors ``load_magpie_weights(q8_native=True)`` keeps for config c."""
    D, F, k, X, LT, LF = c.d_model, c.d_ffn, c.enc_kernel, c.d_xa, c.lt_dim, c.lt_ffn_dim
    el, dl, ncb, V = (c.enc_layers,), (c.dec_layers,), c.num_codebooks, c.vocab_per_cb
    return {
        "encoder.qkv": ((3 * D, D), "linear", el), "encoder.sa_out": ((D, D), "linear", el),
        "encoder.ff_proj": ((F, D, k), "conv_ffn", el),
        "encoder.ff_out": ((D, F, k), "conv_ffn", el),
        "decoder.qkv": ((3 * D, D), "linear", dl), "decoder.sa_out": ((D, D), "linear", dl),
        "decoder.xa_q": ((X, D), "linear", dl), "decoder.xa_kv": ((2 * X, D), "linear", dl),
        "decoder.xa_out": ((D, X), "linear", dl),
        "decoder.ff_proj": ((F, D, 1), "conv1", dl), "decoder.ff_out": ((D, F, 1), "conv1", dl),
        "final_proj_w": ((ncb * V, D), "linear", ()),
        "lt.in_proj_w": ((LT, D), "linear", ()), "lt.qkv": ((3 * LT, LT), "linear", ()),
        "lt.sa_out": ((LT, LT), "linear", ()), "lt.ff_proj": ((LF, LT, 1), "conv1", ()),
        "lt.ff_out": ((LT, LF, 1), "conv1", ()), "lt.out_proj_w": ((V, LT), "linear", (ncb,)),
    }


PROD = allowlist(MagpieConfig())


def _blocks(torch_shape, lead, seed):
    rng = np.random.default_rng(seed)
    n_blocks = int(np.prod(torch_shape)) // q8_dequant.QK
    q = torch.tensor(rng.integers(-127, 128, (*lead, n_blocks, q8_dequant.QK)), dtype=torch.int8)
    s = torch.tensor(rng.normal(0, 0.01, (*lead, n_blocks, 1)).astype(np.float16),
                     dtype=torch.float32)
    return q, s


def test_allowlist_is_the_loaders():
    """The 18 block-stored tensors, their shapes, transforms and stacking,
    as the loader keeps them from a Q8_0 file (tiny config)."""
    c = tiny_magpie_config()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.gguf")
        fixtures.write_tiny_magpie_gguf(path, seed=0, quant="q8_0")
        _, w = load_magpie_weights(path, q8_native=True)
    got = {k: (b.torch_shape, b.transform, tuple(b.q.shape[:-2]))
           for k, b in q8_blocks(w).items()}
    assert got == allowlist(c) and len(PROD) == 18


@DTYPES
@pytest.mark.parametrize("name", list(PROD))
def test_tiling_covers_each_357m_tensor_once_and_equals_plain(name, dtype):
    """One slice of each 357M block-stored tensor (every lead slice is tiled
    alike): each source byte read once, each output element written once,
    the result bit-equal to the plain version in ``dtype``."""
    torch_shape, transform, _ = PROD[name]
    q, s = _blocks(torch_shape, (1,), seed=len(name))
    got, reads, writes = q8_dequant.tiled_model(q, s, torch_shape, transform, dtype)
    want = q8_dequant.dequantize_reference(q, s, torch_shape, transform, dtype)
    assert (reads == 1).all() and (writes == 1).all()
    assert got.dtype == dtype and torch.equal(got, want)


@DTYPES
@pytest.mark.parametrize("torch_shape,transform,lead", [
    ((40, 64), "linear", (3,)), ((96, 32, 1), "conv1", ()), ((64, 40, 3), "conv_ffn", (2,)),
    ((42, 64), "linear", ()), ((44, 40, 3), "conv_ffn", ()), ((130, 96), "linear", (2,))])
def test_tiling_of_ragged_and_unaligned_shapes(torch_shape, transform, lead, dtype):
    """Shapes with ragged tiles, rows that are not whole 16-byte runs (byte
    loads) and an a extent that is not a whole number of 16-byte stores
    (one-value stores), over several lead slices: the same coverage and
    bits."""
    q, s = _blocks(torch_shape, lead, seed=sum(torch_shape))
    got, reads, writes = q8_dequant.tiled_model(q, s, torch_shape, transform, dtype)
    want = q8_dequant.dequantize_reference(q, s, torch_shape, transform, dtype)
    assert (reads == 1).all() and (writes == 1).all()
    assert torch.equal(got, want)
