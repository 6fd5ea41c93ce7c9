"""Where the benchmark finds its parts: every file by the name that
``BENCHMARK.json`` (or a cell's file) gives it. ``root`` is this folder; a
test may point it at a copy holding more files."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def load(kind: str, name: str, root: Path = ROOT) -> dict:
    """``<root>/<kind>/<name>.json``: a configuration or a cell."""
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def module(kind: str, name: str, root: Path = ROOT):
    """``<root>/<kind>/<name>.py`` imported by path (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"port_bench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernels(root: Path = ROOT) -> dict:
    """{kernel: roofline module} of every file in ``rooflines/``."""
    return {p.stem: module("rooflines", p.stem, root)
            for p in sorted((root / "rooflines").glob("*.py")) if not p.stem.startswith("_")}


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1`` (those that list
    the cell, or that list no cells and move an end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]
