"""A whole run at a tiny size on the CPU (the look for a card skipped), sound
and with the timed path broken underneath: each fault the cell can have
has to turn ``correct`` false, an utterance ended early among them (a
wrong EOS test, a slot retired before its EOS). There is one card and no
exchange between cards, so that fault does not arise."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import run

from . import tiny


def _run(cell, monkeypatch=None, patches=()):
    for target, attr, make in patches:
        monkeypatch.setattr(target, attr, make(getattr(target, attr)))
    res = run.run_cell(cell, 2**33 + 5, 6.0, False, device="cpu", overrides=tiny.overrides(cell))
    res.pop("_run")
    return res


EOS = 2017          # the tiny configuration's audio EOS id (the cells' own)
FORBID_C = 15       # kernel C's positional ``forbid``: frames before min_generated_frames


def _frame_c(fault):
    """Kernel C's wrapper as the continuous engine calls it, broken."""
    calls = [0]

    def make(orig):
        def broken(*a, **k):
            calls[0] += 1
            sampled, argmax, hidden, kc, vc = orig(*a, **k)
            if fault == "early_end" and calls[0] % 3 == 0 and not bool(a[FORBID_C][0]):
                argmax = argmax.clone()          # slot 0's EOS test fires a frame too soon
                argmax[0, 0] = EOS
            if fault == "state_unchanged":
                hidden = a[0]
            elif fault == "half_batch":
                half = sampled.shape[0] // 2
                sampled = sampled.clone()
                sampled[half:] = sampled[:sampled.shape[0] - half]
            elif fault == "token_altered":
                sampled = sampled.clone()
                sampled[0, 1] = (sampled[0, 1] + 1) % 2016
            return sampled, argmax, hidden, kc, vc
        return broken
    return make


def _retired_early(orig):
    """Retirement that also ends the first live slot past a few frames, as a
    stale done flag would: its request leaves without an EOS frame."""
    def broken(self, codes_seg, counts_before):
        for slot, rid in enumerate(self._slot_req):
            if rid is not None and not self._done_host[slot] and 4 <= self._counts_host[slot] < 12:
                self._done_host[slot] = True
                break
        return orig(self, codes_seg, counts_before)
    return broken


def _frame_a(fault):
    calls = [0]

    def make(orig):
        def broken(*a, **k):
            calls[0] += 1
            sampled, argmax, hidden, kc, vc = orig(*a, **k)
            if fault == "early_end" and calls[0] % 7 == 0:
                argmax = argmax.clone()          # the EOS test fires a frame too soon
                argmax[0] = EOS
            if fault == "state_unchanged":
                hidden = a[0]
            elif fault == "token_altered":
                sampled = sampled.clone()
                sampled[2] = (sampled[2] + 1) % 2016
            return sampled, argmax, hidden, kc, vc
        return broken
    return make


def _codec_altered(orig):
    """The first vocoded frame (16 samples at the tiny hop) set to full scale."""
    def broken(self, *a, **k):
        out = orig(self, *a, **k)
        if isinstance(out, list):
            return [np.concatenate([np.ones(16, np.float32), x[16:]]) for x in out]
        out = out.copy()
        out[:16] = 1.0
        return out
    return broken


@pytest.mark.parametrize("cell", ["serve-bf16-sat", "stream-f32"])
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "token_altered", "codec",
                                   "early_end", "retired_early"])
def test_serving_faults_are_caught(fault, monkeypatch):
    from magpie_tts_tpu_torch.parallel import continuous
    from magpie_tts_tpu_torch.runtime import engine

    if fault == "codec":
        patches = [(engine.CodecEngine, "decode_batch", _codec_altered)]
    elif fault == "retired_early":
        patches = [(continuous.ContinuousBatchingEngine, "_retire_finished", _retired_early)]
    else:
        patches = [(continuous, "frame_step_batched", _frame_c(fault))]
    res = _run("serve-bf16-sat", monkeypatch, patches)
    assert res["attempted"] > 0
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("fault", ["state_unchanged", "token_altered", "codec", "early_end"])
def test_streaming_faults_are_caught(fault, monkeypatch):
    from magpie_tts_tpu_torch.models import magpie
    from magpie_tts_tpu_torch.runtime import engine

    patches = [(engine.CodecEngine, "decode", _codec_altered)] if fault == "codec" else \
        [(magpie, "frame_step", _frame_a(fault))]
    res = _run("stream-f32", monkeypatch, patches)
    assert res["attempted"] > 0
    assert not res["correct"], res["check"]


@pytest.mark.cuda
def test_cuda_cell_runs_correct_on_the_card():
    """On a card: a short run of a serving cell at full size is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = run.run_cell("serve-bf16-short", 2**31 + 9, 5.0, False)
    res.pop("_run")
    assert res["correct"], res["check"]

