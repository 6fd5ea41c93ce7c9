"""Kernel A: one decode frame (LT sampling + frame embedding + decoder step).

``frame_step`` replaces the TPU kernel
magpie_tts_tpu/ops/pallas_kernels/frame_step.py ``frame_step_pallas`` with
its three weight streams: ``stream=None`` (dense float32), an
``Int8DecoderStream`` or a ``Q8DecoderStream`` supplies the four streamed
decoder matrices, and the kernel dispatches on the type (``stream_mode``).
On CUDA tensors it launches csrc/frame_step.cu: one persistent,
cooperative launch a frame (csrc/frame_persistent.cuh; its plan is
``plan_frame`` here, kernel 4's ``plan_lt``), with a zeroed grid-barrier
count in the call's workspace, or raises (a refused cooperative launch too: there is no other
path); on CPU tensors it runs ``frame_step_reference``, the plain
composition the TPU kernel is pinned against: the split path's two plain
versions, ``lt_sampler.sample_frame_codes_reference`` +
``audio_frame_embedding`` + ``decoder_step.decode_step_reference``.

Both update the K/V caches in place (row ``pos`` of every layer). ``launch``
and the tensor tables here also serve the split path's kernels 4 and 5
(ops/kernels/lt_sampler.py, ops/kernels/decoder_step.py), entry points of
the same source. A stream of the wrong type or shape raises: no path
dequantizes a stream and runs the dense kernel in its place.

Every entry point comes in the two compute dtypes, float32 (``_f32``) and
bfloat16 (``_bf16``): the hidden row's dtype picks one, and every weight,
cache and row the kernel reads must have it (a quantized stream keeps its
int8 values and float32 scales). Any other dtype raises; ``dtype_launches``
counts the launches by dtype, so a bfloat16 run that went through float32
shows.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ...config import MagpieConfig
from ...io.magpie_weights import Int8DecoderStream, MagpieWeights, Q8DecoderStream
from ..attention import attn_scale
from . import build, decode_attention

MODES = ("dense", "int8", "q8")  # the weight streams, by stream_mode
DTYPES, count_dtype = build.DTYPES, build.count_dtype
launches = 0  # kernel launches (one per frame) since the last reset
mode_launches = dict.fromkeys(MODES, 0)  # the same, by weight stream
dtype_launches = dict.fromkeys(("float32", "bfloat16"), 0)  # the same, by compute dtype

# csrc/frame_persistent.cuh: threads of a block, columns of a product tile,
# the row groups that split a tile's K inside a block, a thread's cp.async
# slots (16 bytes each), the grid's blocks an SM, the most K splits of a
# narrow product, the widest product a split may take, and the fewest rows
# of a split.
THREADS = 256
TILE_COLS = 16
ROW_GROUPS = THREADS // (TILE_COLS // 4)
RING = 16
BLOCKS_PER_SM = 1
MAX_SPLIT = 8
SPLIT_MAX_N = 256
SPLIT_MIN_ROWS = 128
SMEM_LIMIT = 227 * 1024
STAMP_WORDS = 4  # a phase stamp: start, prologue end, barrier arrival (ns), kinds
PRO_KINDS = ("none", "ln", "sampling", "attention")  # attention: a one-chunk one, in-block
WORK_KINDS = ("none", "gemv", "attention")


def split_rows(K: int, S: int) -> int:
    """Rows of one K split (csrc split_rows): a multiple of ROW_GROUPS."""
    return (-(-K // S) + ROW_GROUPS - 1) // ROW_GROUPS * ROW_GROUPS


def product_split(K: int, N: int) -> int:
    """K splits of a product, a function of (K, N) only: a narrow product
    (N <= 256, too few tiles to fill the card) splits K into parts of at
    least 128 rows, at most MAX_SPLIT; a wider one does not split."""
    if N > SPLIT_MAX_N:
        return 1
    s = max(1, min(MAX_SPLIT, K // SPLIT_MIN_ROWS))
    return -(-K // split_rows(K, s))


@dataclasses.dataclass(frozen=True)
class Product:
    """One matrix product x[K] @ W[K, N] of a frame, as the persistent
    kernel deals it: ``tiles`` tiles of TILE_COLS columns times ``split``
    K ranges of ``kc`` rows, item i = split * tiles + tile on block i % grid."""
    name: str
    K: int
    N: int
    split: int

    @property
    def tiles(self) -> int:
        return -(-self.N // TILE_COLS)

    @property
    def kc(self) -> int:
        return split_rows(self.K, self.split)

    @property
    def items(self) -> int:
        return self.tiles * self.split

    def item(self, i: int):
        """(rows k0..k1, columns c0..c1) of item i."""
        tile, sp = i % self.tiles, i // self.tiles
        k0 = sp * self.kc
        c0 = tile * TILE_COLS
        return (k0, min(self.K, k0 + self.kc)), (c0, min(self.N, c0 + TILE_COLS))

    def sum_order(self, column: int):
        """The order in which column ``column`` sums its rows: per split, per
        row group g, the rows g's thread adds in order (then the groups by
        the butterfly and the warps in order, the splits in order)."""
        assert 0 <= column < self.N
        out = []
        for sp in range(self.split):
            k0, k1 = sp * self.kc, min(self.K, (sp + 1) * self.kc)
            out.append(tuple(tuple(range(k0 + g, k1, ROW_GROUPS)) for g in range(ROW_GROUPS)))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    work: str    # "gemv", "attention" or "none"
    barrier: bool  # the grid meets after it


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """The persistent kernel's phase table for one frame (kernel A, 4 or
    5): its products and phases."""
    products: Tuple[Product, ...]
    phases: Tuple[Phase, ...]

    @property
    def barriers(self) -> int:
        return sum(ph.barrier for ph in self.phases)

    def product(self, name: str) -> Product:
        return next(p for p in self.products if p.name == name)


def plan_fields(config: MagpieConfig) -> dict:
    """The plan fields of the persistent kernels' arguments: the narrow
    products' K splits (the LT's are passed to kernel 5 too, which runs no
    LT phase) and the tile width."""
    c = config
    D, X, LT, LF = c.d_model, c.d_xa, c.lt_dim, c.lt_ffn_dim
    return dict(split_lt_in=product_split(D, LT), split_lt_sa=product_split(LT, LT),
                split_lt_ff=product_split(LF, LT), split_xa_q=product_split(D, X),
                tile_cols=TILE_COLS)


def _fma(acc: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fmaf in float32, modelled in float64 (the product is exact there)."""
    return (acc.double() + x.double() * w.double()).float()


def _tile_columns(x: torch.Tensor, w: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """One split's column sums as a block forms them: row group g's thread
    sums rows k0 + g, k0 + g + 64, ... in order; the 8 groups of a warp by
    the butterfly (lane ^ 4, ^ 8, ^ 16); the 8 warps in order."""
    steps = -(-(k1 - k0) // ROW_GROUPS)
    xs = torch.zeros(steps * ROW_GROUPS, dtype=torch.float32)
    ws = torch.zeros(steps * ROW_GROUPS, w.shape[1], dtype=torch.float32)
    xs[:k1 - k0], ws[:k1 - k0] = x[k0:k1], w[k0:k1]   # zero rows past k1 add exact zeros
    acc = torch.zeros(ROW_GROUPS, w.shape[1], dtype=torch.float32)
    for j in range(steps):                             # step j: row k0 + 64 j + g of group g
        rows = slice(j * ROW_GROUPS, (j + 1) * ROW_GROUPS)
        acc = _fma(acc, xs[rows, None], ws[rows])
    warps = acc.reshape(THREADS // 32, 8, -1)
    for m in (1, 2, 4):
        warps = warps + warps[:, torch.arange(8) ^ m]
    total = warps[0, 0]
    for wp in range(1, THREADS // 32):
        total = total + warps[wp, 0]
    return total


def gemv_model(x: torch.Tensor, product: Product, grid: int, dense: torch.Tensor = None,
               q: torch.Tensor = None, scales: torch.Tensor = None,
               col_scale: torch.Tensor = None, dtype=torch.float32) -> torch.Tensor:
    """A plain model of one product of the persistent kernels: the items
    dealt round-robin over ``grid`` blocks, each block summing the columns of
    its tiles as ``_tile_columns`` does, the split partials summed in order
    (from 0). Weights: ``dense`` [K, N] (float32 values of ``dtype``), or
    int8 ``q`` [K, N] with Q8_0 block ``scales`` [K / 32, N] (each weight
    rnd(scale * q) in ``dtype``, the kernel's load) or an int8 ``col_scale``
    [N] applied to the sum. x: [K] float32, already rounded to ``dtype``.
    Returns [N] float32, the epilogue's input."""
    K, N = product.K, product.N
    if dense is not None:
        w = dense.float()
    elif scales is not None:
        w = (torch.repeat_interleave(scales.float(), 32, dim=0)[:K] * q.float()).to(dtype).float()
    else:
        w = q.float()
    parts = torch.full((product.split, N), float("nan"))
    for block in range(grid):
        for i in range(block, product.items, grid):
            (k0, k1), (c0, c1) = product.item(i)
            sp = i // product.tiles
            parts[sp, c0:c1] = _tile_columns(x.float(), w[:, c0:c1], k0, k1)
    out = torch.zeros(N, dtype=torch.float32)
    for sp in range(product.split):
        out = out + parts[sp]
    if col_scale is not None:
        out = out * col_scale.float()
    return out


def smem_bytes(config: MagpieConfig) -> int:
    """Dynamic shared memory of a persistent block (csrc psmem_layout)."""
    c = config
    words = 0
    for n in (max(c.d_model, c.d_ffn, c.lt_dim, c.lt_ffn_dim, c.d_xa), c.d_model, c.lt_dim,
              c.d_model, c.vocab_per_cb, decode_attention.MAX_D_HEAD, 32,
              decode_attention.CHUNK_MAX, decode_attention.THREADS * 8,
              decode_attention.CHUNK_MAX, 2 * 8 * TILE_COLS, 256, 32, RING * THREADS * 4):
        words += -(-n // 4) * 4
    return 4 * words


def _lt_phases(config: MagpieConfig, prod: dict) -> list:
    """The 8 LT phases of 6 barriers (kernels A and 4), their products in ``prod``."""
    c = config
    D, LT, LF, V = c.d_model, c.lt_dim, c.lt_ffn_dim, c.vocab_per_cb
    phases = []
    for _ in range(c.num_codebooks):
        for name, K, N in (("lt_in", D, LT), ("lt_qkv", LT, 3 * LT), ("lt_sa_out", LT, LT),
                           ("lt_ff_proj", LT, LF), ("lt_ff_out", LF, LT), ("lt_out", LT, V)):
            prod[name] = Product(name, K, N, product_split(K, N))
            phases.append(Phase(name, "gemv", True))
    return phases


@functools.lru_cache(maxsize=None)
def plan_lt(config: MagpieConfig) -> FramePlan:
    """Kernel 4's phase table: kernel A's 8 LT phases, then the last draw
    (no barrier). Nothing in it depends on the grid or the dtype."""
    prod = {}
    phases = _lt_phases(config, prod) + [Phase("draw", "none", False)]
    return FramePlan(tuple(prod.values()), tuple(phases))


@functools.lru_cache(maxsize=None)
def plan_frame(config: MagpieConfig, enc_rows: int, fused: bool = True) -> FramePlan:
    """The phase table of one frame with ``enc_rows`` encoder rows: kernel A (``fused``: 8 LT phases of 6
    barriers, then the decoder) or kernel 5 (the decoder: 8 barriers a
    layer, 10 when the cross-attention's rows take more than one chunk).
    Nothing in it depends on the grid, the dtype, the weight stream or the
    cache rows attended."""
    c = config
    D, F, X = c.d_model, c.d_ffn, c.d_xa
    prod = {}

    def mm(name, K, N):
        prod[name] = Product(name, K, N, product_split(K, N))
        return Phase(name, "gemv", True)

    def att(name):
        return Phase(name, "attention", True)

    phases = _lt_phases(c, prod) if fused else []
    # a cross-attention whose rows fit one chunk runs in-block, barrier-free
    xa_steps = decode_attention.plan_attention(enc_rows, X // c.dec_xa_heads).chunks > 1
    for _ in range(c.dec_layers):
        phases += [mm("qkv", D, 3 * D), att("sa_scores"), att("sa_pv"), mm("sa_out", D, D),
                   mm("xa_q", D, X)]
        if xa_steps:
            phases += [att("xa_scores"), att("xa_pv")]
        phases += [mm("xa_out", X, D), mm("ff_proj", D, F), mm("ff_out", F, D)]
    phases.append(Phase("final_norm", "none", False))
    return FramePlan(tuple(prod.values()), tuple(phases))


class FrameStepArgs(ctypes.Structure):
    """Mirror of ``struct FrameStepArgs`` in csrc/frame_step.cu."""
    _ptrs = (
        "hidden k_cache v_cache xa_k xa_v "
        "lt_in_w lt_in_b lt_pos lt_norm_self lt_qkv lt_sa_out lt_norm_ff "
        "lt_ff_proj lt_ff_out lt_out_w lt_out_b audio_emb "
        "pos_emb norm_self qkv sa_out norm_xa_q xa_q xa_out norm_ff ff_proj "
        "ff_out norm_out "
        "qkv_q qkv_s sa_out_q sa_out_s ff_proj_q ff_proj_s ff_out_q ff_out_s "
        "sampled argmax hidden_out "
        "part x h q attn f xa lt_x lt_h lt_q lt_k lt_v lt_attn lt_f emb_row "
        "emb_acc att_sc att_po att_tk part2 bar stamps").split()
    _ints = (
        "d_model d_ffn n_layers max_seq enc_rows d_xa n_heads xa_heads "
        "lt_dim lt_ffn n_cb vocab "
        "pos enc_len seed top_k forbid_eos audio_bos_id audio_eos_id "
        "gelu_tanh stream_mode sa_chunk xa_chunk lt_chunk "
        "grid stamp_cap split_lt_in split_lt_sa split_lt_ff split_xa_q tile_cols").split()
    _floats = "temperature eps sa_scale xa_scale lt_scale".split()
    _fields_ = ([(n, ctypes.c_void_p) for n in _ptrs] +
                [(n, ctypes.c_int) for n in _ints] +
                [(n, ctypes.c_float) for n in _floats])


def declare(lib: ctypes.CDLL, base: str = "magpie_frame_step") -> None:
    for suffix in DTYPES.values():
        fn = getattr(lib, f"{base}_{suffix}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    if base == "magpie_frame_step":
        lib.magpie_barrier_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p]
        lib.magpie_barrier_probe.restype = ctypes.c_int


barrier_probe_launches = 0  # launches of the barrier probe since the last reset


def barrier_probe(bar: torch.Tensor, n: int, grid: int = 0) -> None:
    """n grid barriers of the persistent kernels' kind in one cooperative
    launch of ``grid`` blocks (0: two an SM) on ``bar`` (a zeroed int32
    count on the card; each launch starts from the whole passes it finds, so
    it serves launch after launch). A measurement probe: its graph slope
    over n is one barrier's cost. Needs the card: there is no plain version
    of a barrier."""
    global barrier_probe_launches
    if bar.device.type != "cuda" or bar.dtype != torch.int32 or bar.numel() != 1:
        raise ValueError("barrier_probe: bar must be one int32 count on the card")
    lib = build.load_library()
    err = lib.magpie_barrier_probe(bar.data_ptr(), int(n), int(grid),
                                   torch.cuda.current_stream(bar.device).cuda_stream)
    build.check(err, "magpie_barrier_probe")
    barrier_probe_launches += 1


def compute_dtype(who: str, t: torch.Tensor) -> torch.dtype:
    """The compute dtype a kernel runs in: that of ``t`` (its input row),
    float32 or bfloat16; any other raises."""
    if t.dtype not in DTYPES:
        raise ValueError(f"{who}: compute dtype {t.dtype} is not one the kernels take "
                         f"(float32, bfloat16)")
    return t.dtype


def entry_name(base: str, dtype: torch.dtype) -> str:
    return f"{base}_{DTYPES[dtype]}"


def frame_step_reference(hidden: torch.Tensor, pos: int, xa_k: torch.Tensor,
                         xa_v: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         weights: MagpieWeights, config: MagpieConfig, seed: int,
                         temperature: float, top_k: int, forbid_eos: bool,
                         enc_length: Optional[int] = None, stream=None):
    """Plain PyTorch frame: LT sampling, mean code embedding, decoder step
    (the four streamed matrices from ``stream`` when given)."""
    from ...models.magpie import audio_frame_embedding
    from .decoder_step import decode_step_reference
    from .lt_sampler import sample_frame_codes_reference

    sampled, argmax = sample_frame_codes_reference(hidden, weights, config, seed, temperature,
                                                   top_k, forbid_eos)
    emb = audio_frame_embedding(sampled, weights, config)
    hidden = decode_step_reference(emb, pos, xa_k, xa_v, k_cache, v_cache, weights, config,
                                   enc_length=enc_length, stream=stream)
    return sampled, argmax, hidden, k_cache, v_cache


def check_tensor(who: str, name: str, t: torch.Tensor, shape: Tuple[int, ...],
                 dtype=torch.float32) -> None:
    if t.device.type != "cuda" or t.dtype != dtype:
        raise ValueError(f"{who}: {name} must be a {dtype} CUDA tensor, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{who}: {name} must be contiguous and 16-byte aligned")


def stream_mode(stream) -> int:
    """The kernels' ``stream_mode`` of a stream slot: 0 dense (None), 1
    ``Int8DecoderStream``, 2 ``Q8DecoderStream``; anything else raises."""
    if stream is None:
        return 0
    if isinstance(stream, Int8DecoderStream):
        return 1
    if isinstance(stream, Q8DecoderStream):
        return 2
    raise TypeError(f"stream must be None, an Int8DecoderStream or a Q8DecoderStream, "
                    f"got {type(stream).__name__}")


def streamed_shapes(config: MagpieConfig) -> dict:
    """{name: (K, N)} of the four streamed decoder matrices (per layer)."""
    D, F = config.d_model, config.d_ffn
    return {"qkv": (D, 3 * D), "sa_out": (D, D), "ff_proj": (D, F), "ff_out": (F, D)}


def stream_tensors(who: str, stream, config: MagpieConfig) -> dict:
    """{argument name: tensor} of a quantized stream, checked: int8 values
    [L, K, N] (contiguous, 4-byte aligned for the kernels' char4 loads) and
    float32 scales [L, N] (int8 columns) or [L, K / 32, N] (Q8_0 blocks).
    Empty for the dense stream (None)."""
    mode = stream_mode(stream)
    if mode == 0:
        return {}
    L = config.dec_layers
    out = {}
    for name, (K, N) in streamed_shapes(config).items():
        q = getattr(stream, f"{name}_q")
        if q.device.type != "cuda" or q.dtype != torch.int8:
            raise ValueError(f"{who}: {name}_q must be an int8 CUDA tensor, "
                             f"got {q.dtype} on {q.device}")
        if tuple(q.shape) != (L, K, N):
            raise ValueError(f"{who}: {name}_q has shape {tuple(q.shape)}, want {(L, K, N)}")
        if not q.is_contiguous() or q.data_ptr() % 4:
            raise ValueError(f"{who}: {name}_q must be contiguous and 4-byte aligned")
        if mode == 1:
            scale, shape = getattr(stream, f"{name}_s"), (L, N)
        elif K % 32:
            raise ValueError(f"{who}: a Q8_0 stream needs {name}'s K % 32 == 0, got {K}")
        else:
            scale, shape = getattr(stream, f"{name}_bs"), (L, K // 32, N)
        check_tensor(who, f"{name}_s", scale, shape)
        out[f"{name}_q"], out[f"{name}_s"] = q, scale
    return out


def check_config(who: str, config: MagpieConfig, top_k: int = 1) -> None:
    """What the frame sequences take: vocab <= 4096 (one sampling block),
    d_model / d_ffn / lt_ffn_dim <= 4096 (a row the persistent kernels move
    at once), top_k >= 1, GEMV / GEMM widths that are multiples of 4 (float4), and
    attention heads 8 x a power of two wide, at most 256: whole 16-byte
    vectors for the attention's lanes in both dtypes (csrc/frame_kernels.cuh
    attend)."""
    c = config
    if c.vocab_per_cb > 4096 or top_k < 1 or c.num_codebooks > c.lt_max_pos:
        raise ValueError(f"{who}: needs vocab_per_cb <= 4096, top_k >= 1 and "
                         f"num_codebooks <= lt_max_pos")
    for n in (c.d_model, 3 * c.d_model, c.d_ffn, c.d_xa, c.lt_dim, 3 * c.lt_dim, c.lt_ffn_dim,
              c.vocab_per_cb):
        if n % 4:
            raise ValueError(f"{who}: GEMV width {n} is not a multiple of 4")
    for d_head in (c.d_model // c.dec_sa_heads, c.d_xa // c.dec_xa_heads, c.lt_dim):
        vectors = d_head // 8
        if d_head % 8 or d_head > 256 or vectors & (vectors - 1):
            raise ValueError(f"{who}: attention head width {d_head} is not 8 x a power of two "
                             f"up to 256")
    if max(c.d_model, c.d_ffn, c.lt_ffn_dim) > 4096:
        raise ValueError(f"{who}: the persistent kernels move rows of at most 4096 floats")
    if c.num_codebooks > decode_attention.plan_attention(c.num_codebooks, c.lt_dim).chunk:
        raise ValueError(f"{who}: the LT attention's {c.num_codebooks} rows must fit one chunk")
    if smem_bytes(c) > SMEM_LIMIT:
        raise ValueError(f"{who}: a persistent block needs {smem_bytes(c)} bytes of shared "
                         f"memory, more than {SMEM_LIMIT}")


def workspace_sizes(config: MagpieConfig) -> dict:
    """{buffer: float32 elements} of a frame's workspace (the attention's
    apart), in the order it is laid out. The persistent kernels (A, 4, 5)
    alternate their products' outputs and split partials between part and
    part2 (each at most MAX_SPLIT x the widest N). On an H100, kernels A
    and 5 in float32 ran 4-6% slower with part2 laid out right after part
    (and lt_x, lt_h, lt_attn, emb_row and emb_acc, which no persistent
    kernel reads, left out) than in this order (PERF.md), so it stays."""
    c = config
    n_max = max(3 * c.d_model, c.d_ffn, c.vocab_per_cb, 3 * c.lt_dim, c.lt_ffn_dim, c.d_xa)
    return {"part": MAX_SPLIT * n_max, "x": c.d_model, "h": c.d_model, "q": c.d_model,
            "attn": c.d_model, "f": c.d_ffn, "xa": c.d_xa, "lt_x": c.lt_dim,
            "lt_h": c.lt_dim, "lt_q": c.lt_dim, "lt_k": c.num_codebooks * c.lt_dim,
            "lt_v": c.num_codebooks * c.lt_dim, "lt_attn": c.lt_dim, "lt_f": c.lt_ffn_dim,
            "emb_row": c.d_model, "emb_acc": c.d_model, "part2": MAX_SPLIT * n_max}


def _workspace(config: MagpieConfig, device, rows: int, enc_rows: int) -> dict:
    sizes = workspace_sizes(config)
    # 64-float (256 B) granules keep every buffer aligned for float4 access.
    padded = {k: -(-n // 64) * 64 for k, n in sizes.items()}
    ws = torch.empty(sum(padded.values()), dtype=torch.float32, device=device)
    return {**dict(zip(padded, ws.split(list(padded.values())))),
            **decode_attention.frame_workspace(config, 1, rows, enc_rows, device),
            # the grid barrier's arrival count starts at zero
            "bar": torch.zeros(1, dtype=torch.int32, device=device)}


def lt_weight_tensors(weights: MagpieWeights, config: MagpieConfig) -> dict:
    """{argument name: (tensor, required shape)} of the LT and audio-embedding
    weights the LT sampling sequence reads."""
    c = config
    lt = weights.lt
    D, LT, LF, V = c.d_model, c.lt_dim, c.lt_ffn_dim, c.vocab_per_cb
    return {
        "lt_in_w": (lt.in_proj_w, (D, LT)), "lt_in_b": (lt.in_proj_b, (LT,)),
        "lt_pos": (lt.pos_emb, (c.lt_max_pos, LT)), "lt_norm_self": (lt.norm_self, (LT,)),
        "lt_qkv": (lt.qkv, (LT, 3 * LT)), "lt_sa_out": (lt.sa_out, (LT, LT)),
        "lt_norm_ff": (lt.norm_ff, (LT,)), "lt_ff_proj": (lt.ff_proj, (LT, LF)),
        "lt_ff_out": (lt.ff_out, (LF, LT)), "lt_out_w": (lt.out_proj_w, (c.num_codebooks, LT, V)),
        "lt_out_b": (lt.out_proj_b, (c.num_codebooks, V)),
        "audio_emb": (weights.audio_emb, (c.num_codebooks, V, D)),
    }


def decoder_weight_tensors(weights: MagpieWeights, config: MagpieConfig,
                           stream=None) -> dict:
    """{argument name: (tensor, required shape)} of the dense decoder-layer
    weights the decoder sequence reads: with a quantized ``stream`` the four
    streamed matrices come from it (``stream_tensors``), and their dense
    pointers stay null."""
    c = config
    dec = weights.decoder
    L, D, X = c.dec_layers, c.d_model, c.d_xa
    out = {
        "norm_self": (dec.norm_self, (L, D)),
        "norm_xa_q": (dec.norm_xa_q, (L, D)), "xa_q": (dec.xa_q, (L, D, X)),
        "xa_out": (dec.xa_out, (L, X, D)), "norm_ff": (dec.norm_ff, (L, D)),
        "norm_out": (dec.norm_out, (D,)),
    }
    if stream_mode(stream) == 0:
        out.update({name: (getattr(dec, name), (L, K, N))
                    for name, (K, N) in streamed_shapes(c).items()})
    return out


def cache_tensors(k_cache, v_cache, xa_k, xa_v, config: MagpieConfig) -> dict:
    """{argument name: (tensor, required shape)} of one stream's caches
    [L, max_seq, d_model] and cross-attention K/V [L, enc, d_xa]."""
    S, E = k_cache.shape[1], xa_k.shape[1]
    L, D, X = config.dec_layers, config.d_model, config.d_xa
    return {"k_cache": (k_cache, (L, S, D)), "v_cache": (v_cache, (L, S, D)),
            "xa_k": (xa_k, (L, E, X)), "xa_v": (xa_v, (L, E, X))}


def check_stamps(who: str, stamps: Optional[torch.Tensor]) -> int:
    """The phases a phase-stamp buffer holds: int64 [1 + STAMP_WORDS x
    phases] on the card (word 0: the phases written); 0 without one."""
    if stamps is None:
        return 0
    if (stamps.device.type != "cuda" or stamps.dtype != torch.int64 or stamps.dim() != 1
            or not stamps.is_contiguous() or (stamps.numel() - 1) // STAMP_WORDS < 1):
        raise ValueError(f"{who}: stamps must be a contiguous int64 CUDA tensor of 1 + "
                         f"{STAMP_WORDS} x phases words")
    return (stamps.numel() - 1) // STAMP_WORDS


def read_stamps(stamps: torch.Tensor) -> list:
    """The phase records of a stamped launch: [{start, pro, end (ns), pro,
    work}] in order; the barrier wait of a phase is the next one's start
    minus its end."""
    words = stamps.cpu().tolist()
    out = []
    for i in range(int(words[0])):
        t0, t1, t2, kind = words[1 + STAMP_WORDS * i: 1 + STAMP_WORDS * (i + 1)]
        out.append(dict(start=t0, pro_end=t1, end=t2, pro=PRO_KINDS[kind & 15],
                        work=WORK_KINDS[kind >> 4]))
    return out


def launch(entry: str, tensors: dict, outputs: dict, config: MagpieConfig, device,
           stream=None, dtype=torch.float32, grid: int = 0,
           stamps: Optional[torch.Tensor] = None, **scalars) -> None:
    """Validate ``tensors`` ({name: (tensor, shape)}, all in the compute
    ``dtype``) and the weight ``stream``, allocate a workspace on ``device``
    and call the library's ``entry`` with a FrameStepArgs of the tensors, the
    stream's tensors and mode, the workspace, ``outputs`` ({name: tensor})
    and the config's dims; ``scalars`` fill the remaining fields (unset
    pointers are null). Every entry (A, 4, 5) is a persistent kernel and gets
    its plan fields, the grid barrier, ``grid`` (0: the co-resident maximum;
    another value is for tests) and the optional phase ``stamps``."""
    c = config
    for name, (t, shape) in tensors.items():
        check_tensor(entry, name, t, shape, dtype)
    quantized = stream_tensors(entry, stream, c)
    lib = build.load_library()
    ptrs = {name: t.data_ptr() for name, (t, _) in tensors.items()}
    ptrs.update({name: t.data_ptr() for name, t in quantized.items()})
    # self-attention covers rows [0, pos], cross-attention enc_len rows
    rows, enc_rows = scalars.get("pos", 0) + 1, scalars.get("enc_len", 1)
    ptrs.update({k: v.data_ptr()
                 for k, v in _workspace(c, device, rows, enc_rows).items()})
    ptrs.update({k: v.data_ptr() for k, v in outputs.items()})
    scalars.update(plan_fields(c), grid=int(grid), stamp_cap=check_stamps(entry, stamps))
    if stamps is not None:
        ptrs["stamps"] = stamps.data_ptr()
    args = FrameStepArgs(
        **ptrs, d_model=c.d_model, d_ffn=c.d_ffn, n_layers=c.dec_layers, d_xa=c.d_xa,
        n_heads=c.dec_sa_heads, xa_heads=c.dec_xa_heads, lt_dim=c.lt_dim, lt_ffn=c.lt_ffn_dim,
        n_cb=c.num_codebooks, vocab=c.vocab_per_cb,
        audio_bos_id=c.audio_bos_id, audio_eos_id=c.audio_eos_id, gelu_tanh=int(c.gelu_tanh),
        eps=float(c.eps), sa_scale=attn_scale(c.d_model // c.dec_sa_heads),
        xa_scale=attn_scale(c.d_xa // c.dec_xa_heads), lt_scale=attn_scale(c.lt_dim),
        stream_mode=stream_mode(stream), **decode_attention.frame_chunks(c, rows, enc_rows),
        **scalars)
    cuda_stream = torch.cuda.current_stream(device).cuda_stream
    build.check(getattr(lib, entry)(ctypes.addressof(args), cuda_stream), entry)


def sampling_scalars(config: MagpieConfig, seed: int, temperature: float, top_k: int,
                     forbid_eos: bool) -> dict:
    return dict(seed=int(seed), top_k=min(int(top_k), config.vocab_per_cb),
                forbid_eos=int(bool(forbid_eos)), temperature=float(temperature))


def step_scalars(who: str, config: MagpieConfig, pos: int, k_cache, xa_k,
                 enc_length: Optional[int]) -> dict:
    """pos / enc_len / max_seq / enc_rows of a decoder step, range-checked."""
    S, E = k_cache.shape[1], xa_k.shape[1]
    enc_len = E if enc_length is None else int(enc_length)
    if not (0 <= pos < min(S, config.max_pos) and 1 <= enc_len <= E):
        raise ValueError(f"{who}: pos {pos} / enc_length {enc_len} out of range")
    return dict(pos=int(pos), enc_len=enc_len, max_seq=S, enc_rows=E)


def frame_step(hidden: torch.Tensor, pos: int, xa_k: torch.Tensor, xa_v: torch.Tensor,
               k_cache: torch.Tensor, v_cache: torch.Tensor, weights: MagpieWeights,
               config: MagpieConfig, seed: int, temperature: float, top_k: int,
               forbid_eos: bool, enc_length: Optional[int] = None, stream=None,
               grid: Optional[int] = None, stamps: Optional[torch.Tensor] = None):
    """One full frame: sample 8 codes from ``hidden``, embed them, run the
    decoder at ``pos`` (qkv / sa_out / ff_proj / ff_out from ``stream``, an
    Int8DecoderStream or Q8DecoderStream, when given). Returns (sampled [8]
    int32, argmax [8] int32, new hidden [d_model], k_cache, v_cache); the
    caches update in place. ``grid`` (tests only) launches that many blocks
    in place of the co-resident maximum; ``stamps`` (``check_stamps``)
    receives the phase stamps of the launch."""
    global launches
    if hidden.device.type == "cpu":
        return frame_step_reference(hidden, pos, xa_k, xa_v, k_cache, v_cache, weights,
                                    config, seed, temperature, top_k, forbid_eos,
                                    enc_length, stream)
    if hidden.device.type != "cuda":
        raise ValueError(f"frame_step: unsupported device {hidden.device}")
    c = config
    dtype = compute_dtype("frame_step", hidden)
    check_config("frame_step", c, top_k)
    scalars = step_scalars("frame_step", c, pos, k_cache, xa_k, enc_length)
    dev = hidden.device
    sampled = torch.empty(c.num_codebooks, dtype=torch.int32, device=dev)
    argmax = torch.empty(c.num_codebooks, dtype=torch.int32, device=dev)
    hidden_out = torch.empty(c.d_model, dtype=dtype, device=dev)
    tensors = {"hidden": (hidden, (c.d_model,)),
               "pos_emb": (weights.decoder.pos_emb, (c.max_pos, c.d_model)),
               **cache_tensors(k_cache, v_cache, xa_k, xa_v, c),
               **lt_weight_tensors(weights, c), **decoder_weight_tensors(weights, c, stream)}
    launch(entry_name("magpie_frame_step", dtype), tensors,
           dict(sampled=sampled, argmax=argmax, hidden_out=hidden_out), c, dev, stream, dtype,
           grid=grid or 0, stamps=stamps,
           **scalars, **sampling_scalars(c, seed, temperature, top_k, forbid_eos))
    launches += 1
    mode_launches[MODES[stream_mode(stream)]] += 1
    count_dtype(dtype_launches, dtype)
    return sampled, argmax, hidden_out, k_cache, v_cache
