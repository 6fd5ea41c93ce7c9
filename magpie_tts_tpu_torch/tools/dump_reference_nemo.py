"""Hook-based golden dumper for the REAL PyTorch/NeMo Magpie model
(tools/dump_reference_nemo.py, on the port's ``io.golden`` writer: the same
arguments and byte-identical goldens, with no JAX installed).

This is the ground-truth side of the parity chain (analog of the reference's
scripts/dump_reference.py:21-120): forward hooks capture intermediate tensors
from a real checkpoint during inference and write them as golden ``.bin``
files (io/golden.py layout, byte-compatible with the reference dumper), which
``tools.verify_golden`` then compares per layer against the engine's
``tools.dump_golden`` output — localizing any real-weight divergence to a
specific layer the day checkpoints are available.

NeMo itself is an optional heavyweight dependency: the capture machinery
(``TensorCapture``, ``dump_module_outputs``) works on ANY ``torch.nn.Module``
and is unit-tested on a small module; ``load_nemo_magpie`` gates the NeMo
import behind a clear error message.

Usage:
    python -m magpie_tts_tpu_torch.tools.dump_reference_nemo --model magpie.nemo \
        --text "Hello world" --output-dir test_data/reference
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Dict, Iterable, List

from ..io.golden import write_golden

# Module paths to hook on the NeMo MagpieTTS model — one capture per layer
# type, mirroring the per-layer test tiers (SURVEY.md §4; reference
# scripts/dump_reference.py capture list).
DEFAULT_PATTERNS = (
    ["text_embedding", "encoder", "encoder.norm_out"]
    + [f"encoder.layers.{i}" for i in range(6)]
    + ["encoder.layers.0.self_attention", "encoder.layers.0.pos_ff"]
    + ["decoder", "decoder.norm_out"]
    + [f"decoder.layers.{i}" for i in range(12)]
    + ["decoder.layers.0.self_attention", "decoder.layers.0.cross_attention",
       "decoder.layers.0.pos_ff"]
    + ["final_proj", "local_transformer"]
)


def safe_name(module_path: str) -> str:
    """Module path -> filesystem-safe golden name (dots to underscores)."""
    return re.sub(r"[^A-Za-z0-9_]+", "_", module_path.replace(".", "_"))


def _first_tensor(output):
    """Pull the primary tensor out of common module return conventions."""
    import torch

    if isinstance(output, dict):
        output = output.get("output")
    elif isinstance(output, (tuple, list)) and output:
        output = output[0]
    return output if (output is not None and torch.is_tensor(output)) else None


class TensorCapture:
    """Forward-hook recorder: captures named modules' outputs during a run.

    Hooks attach only to exact path matches; each capture keeps the LAST
    output seen (autoregressive loops overwrite earlier steps, matching the
    per-step dump discipline of the reference).
    """

    def __init__(self, model, patterns: Iterable[str]):
        wanted = set(patterns)
        self.captures: Dict[str, "object"] = {}
        self._handles = []
        for name, module in model.named_modules():
            if name in wanted:
                self._handles.append(
                    module.register_forward_hook(self._hook_for(name)))

    def _hook_for(self, name: str):
        def hook(module, args, output):
            tensor = _first_tensor(output)
            if tensor is not None:
                self.captures[name] = tensor.detach().float().cpu()
        return hook

    def close(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def dump_module_outputs(model, run_fn, patterns: Iterable[str],
                        output_dir: str, quiet: bool = False) -> List[str]:
    """Run ``run_fn(model)`` under capture hooks; write one golden .bin per
    captured module into ``output_dir``. Returns the written module paths."""
    import torch

    os.makedirs(output_dir, exist_ok=True)
    with TensorCapture(model, patterns) as cap, torch.no_grad():
        run_fn(model)
        written = []
        for name, tensor in cap.captures.items():
            path = os.path.join(output_dir, f"{safe_name(name)}.bin")
            write_golden(path, tensor.numpy())
            written.append(name)
            if not quiet:
                print(f"  {name}: {tuple(tensor.shape)} -> {path}",
                      file=sys.stderr)
    return written


def load_nemo_magpie(model_path: str, device: str = "cpu"):
    """Load a real NeMo Magpie checkpoint (requires the nemo_toolkit extra)."""
    try:
        from nemo.collections.tts.models import MagpieTTSModel
    except ImportError as e:
        raise SystemExit(
            "NeMo is not installed in this environment. Install "
            "nemo_toolkit[tts] to dump goldens from a real checkpoint; the "
            f"capture machinery itself is NeMo-free. ({e})")
    model = MagpieTTSModel.restore_from(model_path).to(device).eval()
    return model


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True, help=".nemo checkpoint path")
    p.add_argument("--text", default="Hello world")
    p.add_argument("--speaker", type=int, default=0)
    p.add_argument("--output-dir", default="test_data/reference")
    p.add_argument("--device", default="cpu")
    p.add_argument("--patterns", nargs="*", default=None,
                   help="module paths to capture (default: per-layer set)")
    args = p.parse_args(argv)

    model = load_nemo_magpie(args.model, args.device)

    def run(m):
        # NeMo's inference entry; kept minimal — the hooks do the capturing.
        m.synthesize(text=args.text, speaker=args.speaker)

    written = dump_module_outputs(
        model, run, args.patterns or DEFAULT_PATTERNS, args.output_dir)
    print(f"wrote {len(written)} golden tensors to {args.output_dir}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
