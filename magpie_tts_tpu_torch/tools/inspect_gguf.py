"""Print a GGUF file's metadata and tensor table (tools/inspect_gguf.py, on
the port's numpy ``io.gguf.GGUFReader``: the same lines, with no JAX
installed; analog of the reference's model-inspection tooling,
inspect_inference.py / scripts/inspect_codec.py).

Usage:
    python -m magpie_tts_tpu_torch.tools.inspect_gguf model.gguf [--stats]
"""

from __future__ import annotations

import argparse

from ..io.gguf import GGUFReader

TYPE_NAMES = {0: "F32", 1: "F16", 2: "Q4_0", 8: "Q8_0", 26: "I32"}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path")
    p.add_argument("--stats", action="store_true",
                   help="also compute min/max/mean per tensor (reads data)")
    args = p.parse_args(argv)

    r = GGUFReader(args.path)
    print(f"== {args.path} ==")
    print(f"{len(r.metadata)} metadata keys, {len(r.tensors)} tensors\n")
    print("-- metadata --")
    for key, val in r.metadata.items():
        text = repr(val)
        if len(text) > 100:
            text = f"<string, {len(val)} chars>"
        print(f"  {key} = {text}")
    print("\n-- tensors --")
    total = 0
    for name, info in r.tensors.items():
        total += info.nbytes
        line = (f"  {name:64s} {str(info.shape):24s} "
                f"{TYPE_NAMES.get(info.ggml_type, info.ggml_type):5} "
                f"{info.nbytes / 1e6:8.2f} MB")
        if args.stats:
            t = r.tensor(name)
            line += f"  [{t.min():+.4f}, {t.max():+.4f}] mean {t.mean():+.5f}"
        print(line)
    print(f"\ntotal payload: {total / 1e6:.1f} MB")


if __name__ == "__main__":
    main()
