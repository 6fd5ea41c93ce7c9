"""Nothing the benchmark runs loads JAX or the JAX package, judged by the
top-level module name as a whole word (the port's name begins with the JAX
package's), and the reference loads nothing of the port either."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from port_bench import run

ROOT = Path(__file__).resolve().parents[1]


def test_top_level_names_compared_whole():
    assert run.forbidden_modules(["magpie_tts_tpu_torch", "magpie_tts_tpu_torch.ops",
                                  "jaxtyping", "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["magpie_tts_tpu.io.gguf", "jax._src.api", "jaxlib",
                                  "flax.linen"]) == ["flax", "jax", "jaxlib", "magpie_tts_tpu"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_sources_import_no_jax_and_the_reference_none_of_the_port():
    for path in ROOT.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(run.FORBIDDEN), path
        if "reference" in path.parts:
            assert "magpie_tts_tpu_torch" not in tops, path


def test_a_run_process_loads_no_jax():
    """Import the harness and every module of the port it drives, as a run
    does, in a clean interpreter."""
    code = ("import sys, port_bench.run as r, port_bench.check, port_bench.control, "
            "port_bench.port, port_bench.drivers.serve, port_bench.drivers.stream, "
            "magpie_tts_tpu_torch.parallel.continuous, magpie_tts_tpu_torch.runtime.streaming; "
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
