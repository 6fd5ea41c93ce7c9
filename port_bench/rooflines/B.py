"""Kernel B (csrc/codec_conv.cu, wrapper ``snake_causal_conv``): HalfSnake,
then a causal dilated 1-D convolution, + bias (+ residual), for N sequences.

Least time a call = max(flops / peak, bytes / bandwidth): flops
2 * k * C_in * C_out * N * T; bytes the input, the weights, bias and alphas,
the residual, the output, each once.
"""

from __future__ import annotations

SITE = ("magpie_tts_tpu_torch.models.codec", "snake_causal_conv")


def info(*a, **k) -> dict:
    x, w = a[0], a[1]
    residual = k.get("residual", a[6] if len(a) > 6 else None)
    alpha = a[3] if len(a) > 3 else k.get("alpha")
    n_t = x.numel() // x.shape[-1]
    return {"elt": x.element_size(), "nt": n_t, "k": w.shape[0], "cin": w.shape[1],
            "cout": w.shape[2], "residual": residual is not None,
            "alpha": 0 if alpha is None else alpha.numel()}


def least_seconds(calls, hp: dict, peaks: dict, dtype: str):
    total = 0.0
    for c in calls:
        flops = 2.0 * c["k"] * c["cin"] * c["cout"] * c["nt"]
        elems = (c["nt"] * c["cin"] + c["k"] * c["cin"] * c["cout"] + c["cout"] + c["alpha"]
                 + c["nt"] * c["cout"] * (2 if c["residual"] else 1))
        total += max(flops / peaks[dtype], c["elt"] * elems / peaks["bandwidth"])
    return total
