"""Kernel 9: one whole codec res layer in one launch (``MAGPIE_FUSED_CODEC``).

``res_layer_fused`` replaces the TPU kernel
magpie_tts_tpu/ops/pallas_kernels/codec_res_fused.py ``res_layer_fused``: the
3 branches x 3 residual blocks x (HalfSnake + dilated causal in-conv,
HalfSnake + causal sk-conv, + residual) and the mean of the branches, for
x ``[N, T, C]`` with C <= 128. On CUDA tensors it launches
csrc/codec_res_fused.cu or raises; on CPU tensors it runs
``res_layer_fused_reference``. Float32 or bfloat16, x's dtype; the stacked
weights must have it, and any other dtype raises.

The 18 convs' weights are stacked once per layer (``stack_res_layer``;
``runtime.engine.CodecEngine`` keeps one per stage) and handed to every call.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from . import build
from .build import DTYPES, count_dtype
from .codec_conv import (ELT, MAX_SMEM, STAGES, WARP_NTS, WARP_ROWS, WARPS, ring_stride,
                         window_stride)

launches = 0  # kernel launches since the last reset
dtype_launches = dict.fromkeys(("float32", "bfloat16"), 0)  # the same, by compute dtype

MAX_CHANNELS = 128
# Output rows per block the wrapper tries (csrc/codec_res_fused.cu takes any),
# and the kernel's input channels per weight slice (kChunk).
_TILES = (256, 128, 64, 32, 16, 8)
CHUNK = {torch.float32: 32, torch.bfloat16: 64}


def declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for suffix in DTYPES.values():
        fn = getattr(lib, f"magpie_res_layer_fused_{suffix}")
        fn.argtypes = [p, p, p, p, p, ctypes.c_float, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class FusedResLayer:
    """One res layer's convs, stacked for the kernel. Conv order: branch by
    branch, each block's in-conv then its sk-conv."""
    convs: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int], ...]  # (w, b, alpha, dil)
    n_branches: int
    w: torch.Tensor        # every conv's [k, C, C] weights, flattened one after another
    bias: torch.Tensor     # [n_convs, C]
    alpha: torch.Tensor    # [n_convs, C]: Snake alphas, 1 past each conv's n_snake
    meta: Tuple[int, ...]  # n_branches, convs per branch, then (k, dilation, n_snake) per conv

    @property
    def channels(self) -> int:
        return self.bias.shape[1]

    @property
    def halo(self) -> int:
        """The largest branch's causal halo: the rows a tile needs before it."""
        per = len(self.convs) // self.n_branches
        return max(sum((w.shape[0] - 1) * d for w, _, _, d in self.convs[s:s + per])
                   for s in range(0, len(self.convs), per))


def stack_res_layer(branches, dilations: Sequence[int]) -> FusedResLayer:
    """Stack a stage's ``resblocks`` (branches of ResBlockWeights) once."""
    convs = []
    for branch in branches:
        for blk, d in zip(branch, dilations):
            convs.append((blk.in_conv_w, blk.in_conv_b, blk.in_alpha, int(d)))
            convs.append((blk.sk_conv_w, blk.sk_conv_b, blk.sk_alpha, 1))
    C = convs[0][0].shape[1]
    with torch.no_grad():
        alpha = torch.ones(len(convs), C, dtype=convs[0][2].dtype, device=convs[0][2].device)
        for i, (_, _, a, _) in enumerate(convs):
            alpha[i, :a.shape[0]] = a
        w = torch.cat([cw.reshape(-1) for cw, _, _, _ in convs])
        bias = torch.stack([b for _, b, _, _ in convs])
    meta = [len(branches), len(convs) // len(branches)]
    for cw, _, a, d in convs:
        meta += [cw.shape[0], d, a.shape[0]]
    return FusedResLayer(convs=tuple(convs), n_branches=len(branches), w=w, bias=bias,
                         alpha=alpha, meta=tuple(meta))


def res_layer_fused_reference(x: torch.Tensor, layer: FusedResLayer,
                              leaky_slope: float = 0.01) -> torch.Tensor:
    """Plain version of the kernel, with the TPU kernel's rounding points:
    HalfSnake in float32, rounded; each conv's acc + bias in float32, rounded
    once; the block residual and the branch sum in the storage dtype; the
    mean a float32 divide, rounded. In float32 this is models/codec's
    per-conv res_layer."""
    from ...models.codec import causal_conv1d, half_snake

    per = len(layer.convs) // layer.n_branches
    acc = None
    for s in range(0, len(layer.convs), per):
        h = x
        for (w1, b1, a1, d1), (w2, b2, a2, d2) in zip(layer.convs[s:s + per:2],
                                                      layer.convs[s + 1:s + per:2]):
            r = causal_conv1d(half_snake(h, a1, leaky_slope), w1, b1, d1)
            r = causal_conv1d(half_snake(r, a2, leaky_slope), w2, b2, d2)
            h = h + r
        acc = h if acc is None else acc + h
    return (acc.float() / layer.n_branches).to(x.dtype)


def warp_split(channels: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(warps side by side over the channels, n8 tiles each) for a pass of
    the 8 warps: the narrowest cover of the channels by the tiles a warp may
    hold in ``dtype``, then the fewest warps across (the most rows a pass).
    The kernel takes it from here and checks it."""
    n8 = -(-channels // 8)
    return min(((wn, nt) for wn in (1, 2, 4, 8) for nt in WARP_NTS[dtype] if wn * nt >= n8),
               key=lambda p: (p[0] * p[1], p[0]))


def smem_bytes(tile: int, halo: int, channels: int, dtype: torch.dtype) -> int:
    """The two windows (halo + tile rows, in the operand type) and the ring
    of STAGES [CHUNK x the warps' padded width] weight slices."""
    wn, nt = warp_split(channels, dtype)
    return ELT[dtype] * (2 * (halo + tile) * window_stride(channels, dtype)
                         + STAGES * CHUNK[dtype] * ring_stride(wn * nt * 8))


def pass_rows(channels: int, dtype: torch.dtype) -> int:
    """Rows one pass of the 8 warps covers: the warps side by side over the
    channels (``warp_split``), the rest stacked over rows."""
    return WARPS // warp_split(channels, dtype)[0] * WARP_ROWS


def _conv_rows(tile: int, layer: FusedResLayer):
    """(k, rows computed) of each conv of a block: a branch starts at the
    first window row it needs, and each conv computes the rows later convs
    read (the window is the layer's halo plus the tile)."""
    H = layer.halo
    per = len(layer.convs) // layer.n_branches
    for s in range(0, len(layer.convs), per):
        lo = H - sum((w.shape[0] - 1) * d for w, _, _, d in layer.convs[s:s + per])
        for w, _, _, d in layer.convs[s:s + per]:
            lo += (w.shape[0] - 1) * d
            yield w.shape[0], H + tile - lo


def _fits(tile: int, layer: FusedResLayer) -> bool:
    """Whether the kernel takes ``tile``: its two windows and the weight ring
    fit a block's shared memory (a conv's rows take as many passes as they
    need)."""
    return smem_bytes(tile, layer.halo, layer.channels, layer.w.dtype) <= MAX_SMEM


def pick_tile(n: int, T: int, layer: FusedResLayer, n_sms: int) -> int:
    """The tile with the least estimated time: waves of one block per SM
    times a block's weight slices (each conv's taps times the passes of
    ``pass_rows`` its rows take: the halo's rows are recomputed per block and
    the weights re-streamed per pass). Results do not depend on the tile."""
    pm = pass_rows(layer.channels, layer.w.dtype)
    best, best_cost = None, None
    for t in _TILES:
        if not _fits(t, layer):
            continue
        waves = -(-(n * -(-T // t)) // n_sms)
        cost = waves * sum(k * -(-rows // pm) for k, rows in _conv_rows(t, layer))
        if best_cost is None or cost < best_cost:
            best, best_cost = t, cost
    if best is None:
        raise ValueError(f"res_layer_fused: no tile fits C={layer.channels}, "
                         f"halo {layer.halo}")
    return best


def _check(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"res_layer_fused: {name} must be a {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"res_layer_fused: {name} must be contiguous")


def res_layer_fused(x: torch.Tensor, layer: FusedResLayer, leaky_slope: float = 0.01,
                    tile: Optional[int] = None) -> torch.Tensor:
    """x: [N, T, C], C <= 128 -> [N, T, C] in one launch. ``tile`` (output
    rows per block) defaults to ``pick_tile``'s."""
    global launches
    if x.device.type == "cpu":
        return res_layer_fused_reference(x, layer, leaky_slope)
    if x.device.type != "cuda":
        raise ValueError(f"res_layer_fused: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"res_layer_fused: x must be [N, T, C], got {tuple(x.shape)}")
    n, T, C = x.shape
    if C != layer.channels:
        raise ValueError(f"res_layer_fused: x has {C} channels, the layer {layer.channels}")
    if C > MAX_CHANNELS:
        raise ValueError(f"res_layer_fused: C={C} > {MAX_CHANNELS} (the per-conv path serves "
                         f"wider stages)")
    dtype = x.dtype
    if dtype not in DTYPES:
        raise ValueError(f"res_layer_fused: dtype {dtype} is not one the kernel takes "
                         f"(float32, bfloat16)")
    _check("x", x, dtype, x.device)
    for name in ("w", "bias", "alpha"):
        _check(name, getattr(layer, name), dtype, x.device)
    out = torch.empty_like(x)
    if n == 0 or T == 0:
        return out
    if tile is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        tile = pick_tile(n, T, layer, sms)
    elif not _fits(tile, layer):
        raise ValueError(f"res_layer_fused: tile {tile} does not fit C={C}, halo {layer.halo}")
    lib = build.load_library()
    meta = (ctypes.c_int * len(layer.meta))(*layer.meta)
    warps_n, nt = warp_split(C, dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, f"magpie_res_layer_fused_{DTYPES[dtype]}")(
        x.data_ptr(), layer.w.data_ptr(), layer.bias.data_ptr(), layer.alpha.data_ptr(), meta,
        float(leaky_slope), out.data_ptr(), n, T, C, tile, warps_n, nt,
        smem_bytes(tile, layer.halo, C, dtype), stream)
    build.check(err, "res_layer_fused")
    launches += 1
    count_dtype(dtype_launches, dtype)
    return out
