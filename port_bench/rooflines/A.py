"""Kernel A (csrc/frame_step.cu + frame_persistent.cuh, wrapper
``frame_step``): one decode frame of one stream, one persistent launch.

Least time a call = max(flops / peak, bytes / bandwidth), each input byte
counted once: every decoder and local-transformer weight, the K/V rows
0..pos it attends (the new row at ``pos`` written once), the prompt's
cross-attention rows, the 8 code embeddings, the hidden row in and out.
"""

from __future__ import annotations

from port_bench import work as _model

SITE = ("magpie_tts_tpu_torch.models.magpie", "frame_step")


def info(*a, **k) -> dict:
    hidden = a[0] if a else k["hidden"]
    pos = a[1] if len(a) > 1 else k["pos"]
    xa_k = a[2] if len(a) > 2 else k["xa_k"]
    enc = k.get("enc_length")
    return {"elt": hidden.element_size(), "rows": int(pos) + 1,
            "xa_rows": int(enc) if enc is not None else int(xa_k.shape[-2])}


def least_seconds(calls, hp: dict, peaks: dict, dtype: str):
    total = 0.0
    for c in calls:
        flops = _model.frame_matmul_flops(hp) + _model.attention_flops(hp, c["rows"], c["xa_rows"])
        nbytes = c["elt"] * (_model.frame_weight_elements(hp) + _model.kv_elements(hp, c["rows"])
                             + _model.xa_elements(hp, c["xa_rows"])
                             + hp["num_codebooks"] * hp["d_model"] + 2 * hp["d_model"])
        total += max(flops / peaks[dtype], nbytes / peaks["bandwidth"])
    return total
