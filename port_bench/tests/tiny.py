"""A tiny configuration and cell for the benchmark's CPU tests: the cells'
own files with the model cut to a few dozen widths, a few slots and a short
pool, so that a whole run (set-up, window, check) takes seconds on the CPU."""

from __future__ import annotations

from port_bench import spec

MAGPIE = dict(d_model=64, d_ffn=128, d_head=16, enc_layers=1, enc_heads=4, dec_layers=2,
              dec_sa_heads=4, dec_xa_heads=1, dec_xa_d_head=16, lt_dim=32, lt_ffn_dim=64,
              context_frames=8, max_dec_steps=16, max_pos=256)
CODEC = dict(base_channels=16, up_channels=[8, 4], up_sample_rates=[4, 4], up_kernels=[8, 8],
             hop_length=16)
EOS_OFFSET = 0.03       # lengths between 4 and the cap of 16 frames on these weights
LIMITS = {"token_gap": 1e-3, "frame_flips": 0, "codec_requests": 4}   # the cells' numbers


def overrides(cell: str, root=spec.ROOT, dtype: str = "float32") -> dict:
    wl = spec.load("workloads", cell, root)
    cfg = spec.load("configs", wl["config"], root)
    o = {"config": {"dtype": dtype, "magpie": {**cfg["magpie"], **MAGPIE},
                    "codec": {**cfg["codec"], **CODEC}},
         "workload": {"eos_offset": EOS_OFFSET, "check": LIMITS}}
    if wl["driver"] == "serve":
        o["workload"]["engine"] = {**wl["engine"], "slots": 4, "segment_frames": 4}
        o["workload"]["traffic"] = {**wl["traffic"], "clients": 6, "pool_size": 12}
    else:
        o["workload"]["traffic"] = {**wl["traffic"], "pool_size": 4}
    return o
