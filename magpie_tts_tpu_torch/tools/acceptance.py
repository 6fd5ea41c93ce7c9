"""Day-one real-weights acceptance checklist (tools/acceptance.py): one
command, one PASS / FAIL.

The reference pins its parity with concrete oracle values: per-layer golden
tolerances, the exact first greedy frame [293,1454,512,1455,476,40,1817,1014]
of "Hello world" / speaker 0 on the published 357M checkpoint, and a waveform
tolerance of 4.5e-3. The checklist, the JAX tool's:

  1. load       model + codec GGUFs parse (native reader) and map into weights
  2. tokens     tokenizer output (exact vs reference tokens.bin if dumped)
  3. greedy     temp=0 codes of the cached engine (kernel A on a card): frame
                0 vs --first-frame, the whole sequence vs greedy_codes.bin
  3b. q8        (Q8_0 checkpoints) serving the file's own blocks (kernel 10
                and kernel A's Q8_0 stream on a card) reproduces the
                dequantize-at-load greedy codes exactly
  4. goldens    per-layer golden diffs vs the reference dump tree at the
                default tolerances (``tools.verify_golden``), teacher-forced
                on the reference's own frames so a divergence localizes to a
                layer
  5. audio      the greedy codes vocode (``CodecEngine``: kernel B on a card)
                to a finite, non-silent waveform of the right length

Reference dumps come from the real NeMo checkpoint (tools/dump_reference_nemo.py
of the repository, or the reference's dumpers: the same ``.bin`` layout), or
from either package's ``dump_golden``. Without a dump dir the script runs
load / tokens / greedy / audio as a self-check and reports frame 0.

Usage:
    python -m magpie_tts_tpu_torch.tools.acceptance -m magpie-357m-f32.gguf \\
        -c nano-codec-f32.gguf -r test_data/reference [-t "Hello world"] [-s 0] \\
        [--first-frame 293,1454,512,1455,476,40,1817,1014] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

from .verify_golden import compare_dirs

# Published 357M oracle: greedy frame 0 for "Hello world", speaker 0.
REFERENCE_FIRST_FRAME = [293, 1454, 512, 1455, 476, 40, 1817, 1014]
# The tensor whose type says whether a checkpoint is Q8_0.
Q8_PROBE = "decoder.layers.0.self_attention.qkv_net.weight"


class Report:
    """Collects named check results; prints the one-screen verdict."""

    def __init__(self):
        self.rows = []  # (name, status, detail); status in ok / FAIL / skip

    def add(self, name, ok, detail=""):
        self.rows.append((name, "ok" if ok else "FAIL", detail))
        print(f"  {'ok' if ok else 'FAIL':5s} {name:24s} {detail}")
        return ok

    def skip(self, name, why):
        self.rows.append((name, "skip", why))
        print(f"  skip  {name:24s} {why}")

    @property
    def failed(self):
        return [r for r in self.rows if r[1] == "FAIL"]

    def verdict(self):
        n_ok = sum(1 for r in self.rows if r[1] == "ok")
        n_skip = sum(1 for r in self.rows if r[1] == "skip")
        status = "FAIL" if self.failed else "PASS"
        print(f"\nACCEPTANCE: {status}  "
              f"({n_ok} ok, {len(self.failed)} failed, {n_skip} skipped)")
        for name, _s, detail in self.failed:
            print(f"  FAIL {name}: {detail}")
        return 1 if self.failed else 0


def parse_codes(spec):
    return [int(x) for x in spec.replace(",", " ").split()]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-m", "--model", required=True, help="magpie GGUF")
    p.add_argument("-c", "--codec", default=None, help="nano-codec GGUF")
    p.add_argument("-r", "--reference-dump", default=None,
                   help="golden .bin dir (NeMo dump, or either package's dump_golden)")
    p.add_argument("-t", "--text", default="Hello world",
                   help="canonical text (reference dumps use 'Hello world')")
    p.add_argument("-s", "--speaker", type=int, default=0)
    p.add_argument("--first-frame", default=None, metavar="C0,..,C7",
                   help="expected greedy frame-0 codes (357M published value: "
                        + ",".join(map(str, REFERENCE_FIRST_FRAME)) + ")")
    p.add_argument("--max-frames", type=int, default=None,
                   help="greedy decode cap (default: model max_dec_steps)")
    p.add_argument("--dump-dir", default=None,
                   help="keep candidate goldens here (default: temp dir)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="compute dtype; float32 is the parity dtype")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the engines and the traces run (no fallback)")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ..io.golden import read_golden, write_golden
    from ..runtime.engine import resolve_device
    from .dump_golden import greedy_codes, trace_dumps

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    report = Report()
    ref_dir = Path(args.reference_dump) if args.reference_dump else None
    if ref_dir is not None and not any(ref_dir.glob("*.bin")):
        print(f"acceptance: no .bin dumps in {ref_dir}", file=sys.stderr)
        return 2

    # -- 1. load ------------------------------------------------------------
    try:
        from ..io.magpie_weights import load_magpie_weights
        from ..io.native import open_gguf
        from ..text.tokenizer import MagpieTokenizer

        reader = open_gguf(args.model)
        config, weights = load_magpie_weights(args.model, reader=reader, dtype=dtype)
        tokenizer = MagpieTokenizer.from_gguf_metadata(reader.metadata)
        report.add("load_model", True,
                   f"d_model={config.d_model} enc={config.enc_layers}L "
                   f"dec={config.dec_layers}L")
    except Exception as e:  # noqa: BLE001 — any load failure is the finding
        report.add("load_model", False, f"{type(e).__name__}: {e}")
        return report.verdict()

    codec_config = codec_weights = None
    if args.codec:
        try:
            from ..io.codec_weights import load_codec_weights

            codec_config, codec_weights = load_codec_weights(args.codec)
            report.add("load_codec", True,
                       f"hop={codec_config.hop_length} "
                       f"stages={len(codec_config.up_sample_rates)}")
        except Exception as e:  # noqa: BLE001
            report.add("load_codec", False, f"{type(e).__name__}: {e}")
            codec_config = codec_weights = None

    def ref_golden(name):
        if ref_dir is None:
            return None
        path = ref_dir / f"{name}.bin"
        return read_golden(str(path)) if path.exists() else None

    # -- 2. tokens ----------------------------------------------------------
    tokens = tokenizer.encode(args.text)
    ref_tokens = ref_golden("tokens")
    if ref_tokens is not None:
        got = np.asarray(tokens, np.int64)
        want = np.asarray(ref_tokens, np.float32).astype(np.int64).ravel()
        report.add("tokens", got.shape == want.shape and (got == want).all(),
                   f"{len(got)} ids" if got.shape == want.shape else
                   f"{len(got)} ids vs reference {len(want)}")
    else:
        report.skip("tokens", f"{len(tokens)} ids (no reference tokens.bin)")

    # -- 3. greedy e2e ------------------------------------------------------
    n_frames = args.max_frames or config.max_dec_steps
    cand_codes = greedy_codes(weights, config, tokens, args.speaker, n_frames, device)
    if not args.quiet:
        ff = cand_codes[0].tolist() if len(cand_codes) else []
        print(f"  info  greedy: {len(cand_codes)} frames, frame 0 = {ff}")
    if not len(cand_codes):
        report.add("greedy_any_frames", False, "0 frames generated")

    expected_ff = parse_codes(args.first_frame) if args.first_frame else None
    ref_codes = ref_golden("greedy_codes")
    if ref_codes is not None:
        ref_codes = np.asarray(ref_codes, np.float32).astype(np.int64)
        ref_codes = ref_codes.reshape(-1, config.num_codebooks)
        same_shape = cand_codes.shape == ref_codes.shape
        same = same_shape and (cand_codes == ref_codes).all()
        report.add(
            "greedy_codes_e2e", same,
            f"{len(cand_codes)} frames bit-exact" if same else
            (f"frame count {len(cand_codes)} vs {len(ref_codes)}" if not same_shape else
             f"first diff at frame {int(np.argwhere((cand_codes != ref_codes).any(1))[0])}"))
        if expected_ff is None:
            expected_ff = ref_codes[0].tolist()
    if expected_ff is not None:
        got = cand_codes[0].tolist() if len(cand_codes) else []
        report.add("first_frame_codes", got == list(expected_ff),
                   f"{got} vs expected {list(expected_ff)}"
                   if got != list(expected_ff) else str(got))
    elif ref_codes is None:
        report.skip("first_frame_codes", "no --first-frame and no reference greedy_codes.bin")

    # -- 3b. Q8-native serving (only when the checkpoint is Q8_0) ------------
    # Serving the file's own blocks (--serve-q8) must reproduce the
    # dequantize-at-load greedy codes exactly.
    from ..io.gguf import GGML_Q8_0

    probe = reader.tensors.get(Q8_PROBE)
    is_q8_file = probe is not None and probe.ggml_type == GGML_Q8_0
    if is_q8_file and len(cand_codes):
        try:
            from ..io.magpie_weights import q8_stream_from_gguf

            _, weights_q8 = load_magpie_weights(args.model, reader=reader, dtype=dtype,
                                                q8_native=True)
            codes_q8 = greedy_codes(weights_q8, config, tokens, args.speaker, n_frames, device,
                                    q8_stream=q8_stream_from_gguf(reader, config))
            same = np.array_equal(codes_q8, cand_codes)
            report.add("q8_native_codes", same,
                       f"{len(codes_q8)} frames exactly equal" if same else
                       f"q8-native diverged ({codes_q8.shape} vs {cand_codes.shape})")
        except Exception as e:  # noqa: BLE001
            report.add("q8_native_codes", False, f"{type(e).__name__}: {e}")
    elif is_q8_file:
        report.add("q8_native_codes", False, "no greedy frames to compare")
    else:
        report.skip("q8_native_codes", "model is not a Q8_0 checkpoint")

    # -- 4. per-layer goldens (teacher-forced on the reference's frames) -----
    if ref_dir is not None:
        trace_frames = (ref_codes if ref_codes is not None
                        else cand_codes[: min(4, len(cand_codes))])
        codec = None
        if codec_weights is not None:
            codec = (codec_weights.to(device=device), codec_config)
        dumps = trace_dumps(tokens, weights.to(device=device), config, args.speaker,
                            np.asarray(trace_frames, np.int32), codec)
        dumps["greedy_codes"] = cand_codes.astype(np.float32)

        cand_dir = Path(args.dump_dir) if args.dump_dir else Path(
            tempfile.mkdtemp(prefix="magpie_acceptance_"))
        cand_dir.mkdir(parents=True, exist_ok=True)
        for name, arr in dumps.items():
            write_golden(str(cand_dir / f"{name}.bin"), arr)

        n_ok, n_fail, n_missing, _ = compare_dirs(
            ref_dir, cand_dir, quiet=args.quiet, out=None if args.quiet else sys.stdout)
        n_ref = n_ok + n_fail + n_missing
        # Dumps the reference tree has but this trace does not produce count
        # as failures, so an incomplete candidate trace cannot pass.
        report.add("per_layer_goldens", n_fail == 0 and n_missing == 0,
                   f"{n_ok}/{n_ref} within tolerance (candidate dumps in {cand_dir})")
    else:
        report.skip("per_layer_goldens", "no --reference-dump dir")

    # -- 5. audio -----------------------------------------------------------
    if codec_weights is not None and len(cand_codes):
        from ..runtime.engine import CodecEngine

        codec_engine = CodecEngine(codec_weights, codec_config, device=device)
        audio = np.asarray(codec_engine.decode(cand_codes))
        rms = float(np.sqrt(np.mean(np.square(audio, dtype=np.float64))))
        ok = (audio.shape[0] == len(cand_codes) * codec_config.hop_length
              and np.isfinite(audio).all() and rms > 1e-5)
        report.add("audio_synthesis", ok, f"{audio.shape[0]} samples, rms {rms:.4f}")
    elif args.codec:
        report.skip("audio_synthesis", "codec failed to load or 0 frames")
    else:
        report.skip("audio_synthesis", "no codec GGUF given")

    return report.verdict()


if __name__ == "__main__":
    sys.exit(main())
