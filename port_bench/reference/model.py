"""Magpie TTS written out plainly in PyTorch, to judge what the program served.

Teacher-forced: given a prompt, a speaker and the codes the program served,
it computes in one full-sequence pass the logits that every served code was
drawn from. The architecture (SURVEY.md §0; widths from
nvidia/magpie_tts_multilingual_357m as m1el/magpie-tts.cpp src/magpie.h
states them):

- text encoder: token + position embeddings, 6 pre-norm layers of causal
  12-head self-attention and a causal conv feed-forward (kernel 3, GELU),
  a final LayerNorm (no biases anywhere);
- decoder over [speaker context (110 rows); BOS frame; frames 0..n-2], each
  frame embedded as the mean of its 8 codebook embeddings, plus position
  embeddings: 12 pre-norm layers of causal 12-head self-attention,
  single-head cross-attention (d 128) to the LayerNormed encoder output
  masked to the prompt, a pointwise feed-forward, a final LayerNorm; the row
  before frame t predicts frame t;
- local transformer per frame over [in_proj(hidden); in_proj(code
  embeddings of codebooks 0..6)] + its position embeddings: one causal
  single-head layer (d 256); codebook c's logits are row c times its own
  output head, plus bias.

Everything is float32 with TF32 off (``precision="float32"``); the other
precisions are the control's: ``"tf32"`` runs the same products with TF32 on,
``"fp8"`` rounds both operands of every product to float8 e4m3 (a scale per
weight tensor, one per activation row). Weights come as the flat dict the
benchmark made (``"decoder.qkv"`` [L, in, out], ...), in any float dtype.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor (dim None) or per-row scale."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = (amax / FP8_MAX).clamp(min=1e-30)
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@contextlib.contextmanager
def precision_flags(precision: str):
    """TF32 off for "float32" and "fp8" (fp8 rounds its operands itself), on for "tf32"."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Magpie:
    """The model on one device, its weights widened to float32 once."""

    def __init__(self, raw: Dict[str, torch.Tensor], hp: dict, device,
                 precision: str = "float32"):
        if precision not in ("float32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.hp = hp
        self.precision = precision
        self.w = {}
        for k, v in raw.items():
            t = v.to(device=device, dtype=torch.float32)
            if precision == "fp8" and t.dim() >= 2 and not k.endswith(("pos_emb", "_emb", "context")):
                t = torch.stack([fp8_round(x) for x in t]) if t.dim() >= 3 else fp8_round(t)
            self.w[k] = t

    # ---- primitives ------------------------------------------------------

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            x = fp8_round(x, dim=-1)
        return torch.matmul(x, w)

    def ln(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.hp["eps"]) * g

    @staticmethod
    def gelu(x: torch.Tensor) -> torch.Tensor:
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))

    def attend(self, q, k, v, mask):
        """q [..., H, Tq, d], k / v [..., H, Tk, d], mask broadcast to scores."""
        s = self.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        s = s.masked_fill(~mask, -1e30)
        return self.mm(torch.softmax(s, -1), v)

    @staticmethod
    def heads(x, n):
        *b, t, d = x.shape
        return x.reshape(*b, t, n, d // n).transpose(-2, -3)

    @staticmethod
    def merge(x):
        x = x.transpose(-2, -3)
        *b, t, h, d = x.shape
        return x.reshape(*b, t, h * d)

    def self_attention(self, x, qkv_w, out_w, n_heads):
        t = x.shape[-2]
        q, k, v = self.mm(x, qkv_w).chunk(3, dim=-1)
        idx = torch.arange(t, device=x.device)
        causal = idx[None, :] <= idx[:, None]
        o = self.attend(self.heads(q, n_heads), self.heads(k, n_heads), self.heads(v, n_heads),
                        causal)
        return self.mm(self.merge(o), out_w)

    # ---- encoder ---------------------------------------------------------

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [R, T] (right-padded; causal, so padding never reaches a
        valid row) -> encoder output [R, T, D]."""
        w, hp = self.w, self.hp
        T = tokens.shape[-1]
        x = w["text_emb"][tokens] + w["encoder.pos_emb"][:T]
        for l in range(hp["enc_layers"]):
            h = self.ln(x, w["encoder.norm_self"][l])
            x = x + self.self_attention(h, w["encoder.qkv"][l], w["encoder.sa_out"][l],
                                        hp["enc_heads"])
            h = self.ln(x, w["encoder.norm_ff"][l])
            x = x + self.causal_conv_ffn(h, w["encoder.ff_proj"][l], w["encoder.ff_out"][l])
        return self.ln(x, w["encoder.norm_out"])

    def causal_conv_ffn(self, x, proj, out):
        """Causal conv (kernel k, no bias) -> GELU -> causal conv; proj [k, D, F]."""
        def conv(h, wk):
            k = wk.shape[0]
            hp = F.pad(h, (0, 0, k - 1, 0))
            T = h.shape[-2]
            return sum(self.mm(hp[..., i:i + T, :], wk[i]) for i in range(k))
        return conv(self.gelu(conv(x, proj)), out)

    # ---- decoder ---------------------------------------------------------

    def frame_embedding(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [..., 8] -> mean of the per-codebook embeddings [..., D]."""
        emb = self.w["audio_emb"]
        cb = torch.arange(codes.shape[-1], device=codes.device)
        return emb[cb, codes.long()].mean(-2)

    def decoder_hiddens(self, enc: torch.Tensor, enc_len: torch.Tensor, speakers: torch.Tensor,
                        codes: torch.Tensor) -> torch.Tensor:
        """enc [R, Te, D], enc_len [R], speakers [R], codes [R, N, 8] (right
        padded) -> hidden [R, N, D]: row t is the normed output that frame t
        was drawn from."""
        w, hp = self.w, self.hp
        R, N = codes.shape[:2]
        ctx = w["baked_context"][speakers]                              # [R, 110, D]
        bos = torch.full((R, 1, codes.shape[-1]), hp["audio_bos_id"], device=codes.device,
                         dtype=codes.dtype)
        frames = self.frame_embedding(torch.cat([bos, codes[:, :-1]], 1))
        x = torch.cat([ctx, frames], 1)
        x = x + w["decoder.pos_emb"][:x.shape[1]]
        keys = torch.arange(enc.shape[1], device=enc.device)
        xa_mask = (keys[None, :] < enc_len[:, None])[:, None, None, :]   # [R, 1, 1, Te]
        for l in range(hp["dec_layers"]):
            h = self.ln(x, w["decoder.norm_self"][l])
            x = x + self.self_attention(h, w["decoder.qkv"][l], w["decoder.sa_out"][l],
                                        hp["dec_sa_heads"])
            q = self.mm(self.ln(x, w["decoder.norm_xa_q"][l]), w["decoder.xa_q"][l])
            mem = self.ln(enc, w["decoder.norm_xa_mem"][l])
            k, v = self.mm(mem, w["decoder.xa_kv"][l]).chunk(2, dim=-1)
            n = hp["dec_xa_heads"]
            o = self.attend(self.heads(q, n), self.heads(k, n), self.heads(v, n), xa_mask)
            x = x + self.mm(self.merge(o), w["decoder.xa_out"][l])
            h = self.ln(x, w["decoder.norm_ff"][l])
            x = x + self.mm(self.gelu(self.mm(h, w["decoder.ff_proj"][l])), w["decoder.ff_out"][l])
        x = self.ln(x, w["decoder.norm_out"])
        n_ctx = hp["context_frames"]
        return x[:, n_ctx:n_ctx + N]

    # ---- local transformer -----------------------------------------------

    def lt_logits(self, hidden: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """hidden [F, D], codes [F, 8] -> logits [F, 8, V] of each codebook
        given the codes before it in the frame."""
        w = self.w
        n_cb = codes.shape[-1]
        emb = w["audio_emb"][torch.arange(n_cb - 1, device=codes.device), codes[:, :-1].long()]
        rows = torch.cat([hidden[:, None], emb], 1)                     # [F, 8, D]
        x = self.mm(rows, w["lt.in_proj_w"]) + w["lt.in_proj_b"]
        x = x + w["lt.pos_emb"][:n_cb]
        h = self.ln(x, w["lt.norm_self"])
        x = x + self.self_attention(h, w["lt.qkv"], w["lt.sa_out"], 1)
        h = self.ln(x, w["lt.norm_ff"])
        x = x + self.mm(self.gelu(self.mm(h, w["lt.ff_proj"])), w["lt.ff_out"])
        out_w, out_b = w["lt.out_proj_w"], w["lt.out_proj_b"]           # [8, d, V], [8, V]
        return torch.stack([self.mm(x[:, c], out_w[c]) for c in range(n_cb)], 1) + out_b

    def logits(self, tokens: Sequence[Sequence[int]], speakers: Sequence[int],
               codes: Sequence[torch.Tensor]) -> list:
        """Teacher-forced logits [n_i, 8, V] for R requests at once."""
        dev = self.w["text_emb"].device
        R = len(tokens)
        Tmax = max(len(t) for t in tokens)
        Nmax = max(int(c.shape[0]) for c in codes)
        tok = torch.zeros(R, Tmax, dtype=torch.long, device=dev)
        cod = torch.zeros(R, Nmax, codes[0].shape[-1], dtype=torch.long, device=dev)
        for i, (t, c) in enumerate(zip(tokens, codes)):
            tok[i, :len(t)] = torch.as_tensor(list(t), device=dev)
            cod[i, :c.shape[0]] = torch.as_tensor(c, device=dev).long()
        enc_len = torch.tensor([len(t) for t in tokens], device=dev)
        spk = torch.as_tensor(list(speakers), device=dev).long()
        with precision_flags(self.precision), torch.no_grad():
            enc = self.encode(tok)
            hid = self.decoder_hiddens(enc, enc_len, spk, cod)
            out = []
            for i, c in enumerate(codes):
                n = int(c.shape[0])
                out.append(self.lt_logits(hid[i, :n], cod[i, :n]))
        return out
