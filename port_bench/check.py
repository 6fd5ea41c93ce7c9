"""What decides ``correct``: the served codes and audio against the plain reference.

After the window has closed and the program's state is freed, the reference
(``reference/``, float32, TF32 off) runs teacher-forced over a sample, drawn
from the seed, of the requests the window finished (``token_requests`` of
them, all when fewer finished, the longest always in), with the prompt,
speaker and codes the program served, and the codec over a smaller sample
(``codec_requests``). Each number the cell's ``check`` names is held to its limit there:

- ``token_gap``: over every served code, the least change of the
  reference's logits (at most, in logits) under which the sampling rule
  would have served it (``reference.sampling.token_gaps``: top-k, Gumbel-max
  with the request's own noise, and an EOS that would have ended the frame),
  and at the frame each request ended on, the least change under which the
  rule would have ended it there (``reference.sampling.end_gap``), unless it
  ran to ``max_dec_steps``. 0 where the rule, under the reference, picks the
  served code and ends where the program ended; a sound run reads rounding
  near ties only.
- the codec's PCM against the reference's decode of the same codes
  (``codec_reading``: ``frame_err``, ``frame_flips``, ``rel_rms``).

The control (``control.py``) puts the reference computed in the next lower
precision in the program's place, reads the same numbers and holds them to
the same limits (``limited``, ``verdict``): it has to come out not correct.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import List, Optional

import numpy as np
import torch

from .reference import sampling
from .reference.codec import Codec
from .reference.model import Magpie

BATCH = 16  # requests a reference pass
CODEC_NUMBERS = ("frame_err", "frame_flips", "rel_rms")  # those a cell's limits name are held


@dataclasses.dataclass
class Served:
    tokens: tuple
    speaker: int
    codes: np.ndarray         # [n, 8] int
    frame_seeds: np.ndarray   # [n + 1] int32: the seed each frame was sampled with, EOS's last
    audio: Optional[np.ndarray] = None   # float32 [n * hop], the program's PCM
    end: Optional[np.ndarray] = None     # [8] the codes of the EOS frame; None: none reported


def model_hp(mcfg) -> dict:
    return dataclasses.asdict(mcfg)


def codec_hp(ccfg) -> dict:
    return dataclasses.asdict(ccfg)


def token_readings(served: List[Served], judge: Magpie, hp: dict, temperature: float,
                   top_k: int, chooser: Optional[Magpie] = None):
    """(gaps, ends): the widest gap of each served request (of the chooser's first codes
    when a chooser is given), its ending included: a request of fewer than
    ``max_dec_steps`` frames ended on an EOS frame, and the rule has to end
    it there too (``sampling.end_gap``, teacher-forced with the EOS frame's
    own codes); one that reports no EOS frame reads infinite. The chooser is
    judged at the end frame by what it would do there: end (the gap of
    ending) or go on (the gap of its codes, EOS's lead included). ``ends``
    holds the end frame's part alone (NaN where the cap ended the request).
    Requests go through in length order, BATCH at a time."""
    out = np.zeros(len(served))
    ends = np.full(len(served), np.nan)
    order = sorted(range(len(served)), key=lambda i: served[i].codes.shape[0])
    kw = dict(eos_id=hp["audio_eos_id"], bos_id=hp["audio_bos_id"],
              min_frames=hp["min_generated_frames"])
    cap = int(hp["max_dec_steps"])
    for start in range(0, len(order), BATCH):
        idx = order[start:start + BATCH]
        for i in idx:
            if served[i].codes.shape[0] < cap and served[i].end is None:
                out[i] = ends[i] = np.inf
        idx = [i for i in idx if np.isfinite(out[i]) and teacher_codes(served[i], cap).shape[0]]
        if not idx:
            continue
        args = ([served[i].tokens for i in idx], [served[i].speaker for i in idx],
                [torch.as_tensor(teacher_codes(served[i], cap)) for i in idx])
        ref = judge.logits(*args)
        other = chooser.logits(*args) if chooser is not None else [None] * len(idx)
        for i, lg, ot in zip(idx, ref, other):
            n = served[i].codes.shape[0]
            dev = lg.device
            seeds = torch.as_tensor(served[i].frame_seeds.astype(np.int64), device=dev)
            frames = torch.arange(n, device=dev)
            codes = torch.as_tensor(served[i].codes, device=dev).long()
            choose = None
            if ot is not None:
                choose = sampling.rule_choice(ot[:n], seeds[:n], frames, temperature, top_k, **kw)
            gap = 0.0
            if n:
                gap = float(sampling.token_gaps(lg[:n], codes, seeds[:n], frames, temperature,
                                                top_k, choose=choose, **kw).max())
            if n < cap:
                end = sampling.end_gap(lg[n], seeds[n], n, temperature, top_k, **kw)
                if ot is not None and not sampling.rule_ends(ot[n], seeds[n], n, temperature,
                                                             top_k, **kw):
                    nxt = sampling.rule_choice(ot[n:n + 1], seeds[n:n + 1], frames[:1] + n,
                                               temperature, top_k, **kw)
                    end = float(sampling.token_gaps(lg[n:n + 1], nxt, seeds[n:n + 1],
                                                    frames[:1] + n, temperature, top_k, **kw)[0])
                gap = max(gap, end)
                ends[i] = end
            out[i] = gap
        del ref, other
    return out, ends


def teacher_codes(item: Served, cap: int) -> np.ndarray:
    """The codes the reference is teacher-forced with: the served frames and,
    for a request that ended before the cap, the EOS frame's codes."""
    if item.codes.shape[0] < cap and item.end is not None:
        return np.concatenate([item.codes, np.asarray(item.end).reshape(1, -1)], 0)
    return item.codes


def worst_positions(item: Served, judge: Magpie, hp: dict, temperature: float, top_k: int,
                    n: int = 3) -> list:
    """Where one request's gap is widest: frame, codebook, the served code and
    the rule's choice under the reference, with their logits and noise."""
    n = item.codes.shape[0]
    if not n:
        return []
    lg = judge.logits([item.tokens], [item.speaker], [torch.as_tensor(item.codes)])[0].double()
    dev = lg.device
    frames = torch.arange(n, device=dev)
    seeds = torch.as_tensor(item.frame_seeds[:n].astype(np.int64), device=dev)
    codes = torch.as_tensor(item.codes, device=dev).long()
    kw = dict(eos_id=hp["audio_eos_id"], bos_id=hp["audio_bos_id"],
              min_frames=hp["min_generated_frames"])
    choice = sampling.rule_choice(lg, seeds, frames, temperature, top_k, **kw)
    g = sampling.gumbel(seeds, lg.shape[1], lg.shape[2])
    per = sampling.token_gaps(lg, codes, seeds, frames, temperature, top_k, **kw)
    out = []
    for f in per.argsort(descending=True)[:n].tolist():
        cb = int((codes[f] != choice[f]).nonzero()[0]) if bool((codes[f] != choice[f]).any()) else 0
        s, c = int(codes[f, cb]), int(choice[f, cb])
        kth = float(lg[f, cb].topk(top_k).values[-1])
        out.append({"frame": f, "of": int(lg.shape[0]), "cb": cb, "gap": float(per[f]),
                    "served": s, "choice": c, "logit_served": float(lg[f, cb, s]),
                    "logit_choice": float(lg[f, cb, c]), "kth": kth,
                    "noise_served": float(g[f, cb, s]), "noise_choice": float(g[f, cb, c]),
                    "codes_differ": int((codes[f] != choice[f]).sum())})
    return out


def codec_reading(codes: np.ndarray, audio: np.ndarray, judge: Codec, hop: int) -> dict:
    """``audio`` against the judge's decode of ``codes``: ``frame_err``, the
    largest RMS error of one frame over the request's RMS; ``frame_flips``,
    the most samples of one frame off by more than 0.5 (the random codec
    saturates its tanh, so a sample is near +-1 and a wrong one is far off);
    ``rel_rms``, the RMS error over the request's RMS."""
    dev = judge.w["pre_conv_w"].device
    ref = judge.decode(torch.as_tensor(codes, device=dev)[None])[0].double()
    got = torch.as_tensor(np.asarray(audio), device=dev).double()
    if got.shape != ref.shape:
        return {"frame_err": float("inf"), "frame_flips": float("inf"), "rel_rms": float("inf")}
    n = codes.shape[0]
    diff = (got - ref).reshape(n, hop)
    scale = ref.pow(2).mean().sqrt().clamp(min=1e-12)
    return {"frame_err": float(diff.pow(2).mean(-1).sqrt().max() / scale),
            "frame_flips": float((diff.abs() > 0.5).sum(-1).max()),
            "rel_rms": float(diff.pow(2).mean().sqrt() / scale)}


def sample_of(served: List[Served], k: int, seed: int) -> List[int]:
    """``k`` of the served requests drawn from the seed, the longest in."""
    from .traffic import sample

    longest = max(range(len(served)), key=lambda i: served[i].codes.shape[0])
    return sample(len(served), k, seed, always=(longest,))


def run(served: List[Served], raw_magpie, raw_codec, mcfg, ccfg, limits: dict,
        temperature: float, top_k: int, seed: int, device) -> dict:
    """The check of one run: {name: (reading, limit)}, plus ``correct``."""
    hp, chp = model_hp(mcfg), codec_hp(ccfg)
    if not served:
        return {"correct": False, "numbers": {}, "why": "no request finished"}
    judge = Magpie(raw_magpie, hp, device)
    served = [served[i] for i in sample_of(served, int(limits.get("token_requests", 600)),
                                                  seed)]
    gaps, ends = token_readings(served, judge, hp, temperature, top_k)
    finite = np.where(np.isfinite(gaps), gaps, -1.0)
    worst = int(np.argmax(finite))
    detail = {"token_gap_worst": worst_positions(served[worst], judge, hp, temperature, top_k),
              "token_gap_quantiles": np.quantile(finite, [0.5, 0.9, 0.99, 1.0]).tolist(),
              "token_gap_over_0.1": int((gaps > 0.1).sum()),
              "end_gap_max": float(np.nanmax(ends)) if not np.isnan(ends).all() else None,
              "ended_without_eos": int(np.isinf(gaps).sum()),
              "ended_by_eos": int(sum(s.codes.shape[0] < hp["max_dec_steps"] for s in served))}
    del judge
    gc.collect()
    codec = Codec(raw_codec, chp, device)
    picks = sample_of(served, int(limits.get("codec_requests", 8)), seed)
    readings = [codec_reading(served[i].codes, served[i].audio, codec, ccfg.hop_length)
                for i in picks if served[i].codes.shape[0] > 0]
    codec_numbers = {k: max(r[k] for r in readings) if readings else 0.0
                     for k in CODEC_NUMBERS}
    detail["codec"] = codec_numbers
    numbers = limited({"token_gap": float(gaps.max()), **codec_numbers}, limits)
    return {"correct": verdict(numbers), "numbers": numbers, "detail": detail,
            "checked": {"requests": len(served), "frames": int(sum(s.codes.shape[0] for s in served)),
                        "codec_requests": len(readings)}}


def limited(readings: dict, limits: dict) -> dict:
    """{name: (reading, limit)} of each number the cell's limits name."""
    return {name: (float(readings[name]), float(limits[name]))
            for name in ("token_gap",) + CODEC_NUMBERS if name in limits}


def verdict(numbers: dict) -> bool:
    """``correct``: every number compared is finite and within its limit.
    The program's numbers and the control's are held to it alike."""
    return bool(numbers) and all(np.isfinite(v) and v <= lim for v, lim in numbers.values())
