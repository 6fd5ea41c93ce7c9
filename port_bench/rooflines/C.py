"""Kernel C (csrc/frame_step_batched.cu, wrapper ``frame_step_batched``): one
decode frame for B slots of the continuous engine.

Least time a call = max(flops / peak, bytes / bandwidth), each input byte
counted once: every decoder and local-transformer weight (read once a slot
group of at most 64), the K/V rows the mask holds valid for each slot that
goes on, the new K/V row each such slot writes, the cross-attention rows of
its prompt, the code embeddings it looks up, the hidden / position rows in
and out. Flops: the products of every slot and the attention over its valid
rows.
"""

from __future__ import annotations

import torch

from port_bench import work as _model

SITE = ("magpie_tts_tpu_torch.parallel.continuous", "frame_step_batched")
MAX_SLOTS = 64


def _arg(a, k, i, name):
    return a[i] if len(a) > i else k[name]


def info(*a, **k) -> dict:
    """Shapes and, as device scalars (no host read), the rows the frame reads."""
    hidden, valid = _arg(a, k, 0, "hidden"), _arg(a, k, 2, "valid")
    go = _arg(a, k, 3, "may_continue")
    enc = _arg(a, k, 11, "enc_lengths")
    B = hidden.shape[0]
    valid = valid if valid.dim() == 2 else valid[None].expand(B, -1)
    go = go.expand(B) if go.dim() == 0 else go
    return {"B": B, "elt": hidden.element_size(),
            "live": go.sum(), "kv_rows": (valid & go[:, None]).sum(),
            "xa_rows": (enc.to(torch.int64) * go).sum()}


def least_seconds(calls, hp: dict, peaks: dict, dtype: str):
    counts = torch.stack([torch.stack([c["live"], c["kv_rows"], c["xa_rows"]])
                          for c in calls]).cpu().tolist()
    total = 0.0
    for c, (live, kv_rows, xa_rows) in zip(calls, counts):
        B, elt = c["B"], c["elt"]
        groups = -(-B // MAX_SLOTS)
        flops = B * _model.frame_matmul_flops(hp) + _model.attention_flops(hp, kv_rows + live,
                                                                           xa_rows)
        nbytes = elt * (groups * _model.frame_weight_elements(hp)
                        + _model.kv_elements(hp, kv_rows + live)
                        + _model.xa_elements(hp, xa_rows)
                        + B * hp["num_codebooks"] * hp["d_model"]
                        + 3 * B * hp["d_model"])
        total += max(flops / peaks[dtype], nbytes / peaks["bandwidth"])
    return total
