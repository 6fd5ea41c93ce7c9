"""Operations and bytes of Magpie TTS at a configuration's widths: what the
algorithm needs, counted from the shapes (a multiply-add is 2 flops).

Used by the kernels' rooflines (``rooflines/``) and by ``mfu``: the flops of
the work a window completed (each finished request's prepare, its frames,
its codec) over the window's seconds and the card's peak.
"""

from __future__ import annotations


def decoder_matmul_params(hp: dict) -> int:
    """Weights a decoder position multiplies by (cross-attention K/V aside:
    they are the prompt's, computed once)."""
    D, F, dxa = hp["d_model"], hp["d_ffn"], hp["dec_xa_heads"] * hp["dec_xa_d_head"]
    return hp["dec_layers"] * (3 * D * D + D * D + D * dxa + dxa * D + 2 * D * F)


def lt_matmul_params(hp: dict) -> int:
    """Weights one frame's local transformer multiplies by, summed over its
    codebook steps: 8 input projections, and per codebook step the layer for
    its new row and that codebook's output head."""
    D, lt, ltf, cb, V = hp["d_model"], hp["lt_dim"], hp["lt_ffn_dim"], hp["num_codebooks"], \
        hp["vocab_per_cb"]
    return cb * D * lt + cb * (3 * lt * lt + lt * lt + 2 * lt * ltf + lt * V)


def frame_matmul_flops(hp: dict) -> float:
    return 2.0 * (decoder_matmul_params(hp) + lt_matmul_params(hp))


def attention_flops(hp: dict, kv_rows: float, xa_rows: float) -> float:
    """Scores and weighted sums over ``kv_rows`` self-attention rows and
    ``xa_rows`` cross-attention rows (totals over slots), every layer."""
    dxa = hp["dec_xa_heads"] * hp["dec_xa_d_head"]
    return 4.0 * hp["dec_layers"] * (kv_rows * hp["d_model"] + xa_rows * dxa)


def frame_weight_elements(hp: dict) -> int:
    """Weight elements a frame reads: decoder (with its norms), local
    transformer (with bias, position rows and norms)."""
    D, lt, V, cb = hp["d_model"], hp["lt_dim"], hp["vocab_per_cb"], hp["num_codebooks"]
    norms = hp["dec_layers"] * 4 * D + D
    lt_rest = lt + cb * V + (cb + 1) * lt + 2 * lt
    return decoder_matmul_params(hp) + norms + _lt_weights(hp) + lt_rest


def _lt_weights(hp: dict) -> int:
    D, lt, ltf, cb, V = hp["d_model"], hp["lt_dim"], hp["lt_ffn_dim"], hp["num_codebooks"], \
        hp["vocab_per_cb"]
    return D * lt + 3 * lt * lt + lt * lt + 2 * lt * ltf + cb * lt * V


def kv_elements(hp: dict, rows: float) -> float:
    return 2.0 * hp["dec_layers"] * hp["d_model"] * rows


def xa_elements(hp: dict, rows: float) -> float:
    return 2.0 * hp["dec_layers"] * hp["dec_xa_heads"] * hp["dec_xa_d_head"] * rows


def prepare_flops(hp: dict, prompt: int) -> float:
    """Encoder over the prompt, the cross-attention K/V of every layer, the
    speaker context and BOS rows through the decoder."""
    D, F, dxa = hp["d_model"], hp["d_ffn"], hp["dec_xa_heads"] * hp["dec_xa_d_head"]
    enc = hp["enc_layers"] * (2.0 * prompt * (4 * D * D + 2 * hp["enc_kernel"] * D * F)
                              + 2.0 * D * prompt * (prompt + 1))
    xa_kv = 2.0 * hp["dec_layers"] * prompt * D * 2 * dxa
    rows = hp["context_frames"] + 1
    prefill = 2.0 * rows * decoder_matmul_params(hp) + attention_flops(
        hp, rows * (rows + 1) / 2, rows * prompt)
    return enc + xa_kv + prefill


def frames_flops(hp: dict, n: int, prompt: int) -> float:
    """A request's n frames: every frame's products, attention over the
    rows before it."""
    first = hp["context_frames"] + 2
    rows = n * first + n * (n - 1) / 2
    return n * frame_matmul_flops(hp) + attention_flops(hp, rows, n * prompt)


def codec_flops_per_frame(chp: dict) -> float:
    """The codec's convolutions for one frame (hop samples)."""
    flops = 2.0 * chp["pre_conv_kernel"] * chp["latent_dim"] * chp["base_channels"]
    steps = 1
    cin = chp["base_channels"]
    for rate, cout, kup in zip(chp["up_sample_rates"], chp["up_channels"], chp["up_kernels"]):
        flops += 2.0 * cin * kup * steps           # grouped transposed conv, 2 inputs a group
        steps *= rate
        per_branch = sum(2 * 2.0 * k * cout * cout for k in chp["resblock_kernel_sizes"])
        flops += steps * len(chp["resblock_dilations"]) * per_branch
        cin = cout
    flops += steps * 2.0 * chp["post_conv_kernel"] * cin
    return flops


def window_flops(hp: dict, chp: dict, items: list) -> float:
    """Flops of the requests a window finished (``items``: tokens, codes)."""
    total = 0.0
    per_frame_codec = codec_flops_per_frame(chp)
    for d in items:
        n, prompt = int(d["codes"].shape[0]), len(d["req"].tokens)
        total += prepare_flops(hp, prompt) + frames_flops(hp, n, prompt) + n * per_frame_codec
    return total
