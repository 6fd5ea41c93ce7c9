"""BENCHMARK.json against the contract it is held to, every file it names
found by name, and a cell added by files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from port_bench import run, spec

from . import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in CELLS:
        reported = {m["name"] for m in spec.cell_metrics(BENCH, cell, False)}
        assert "setup_s" in reported and len(reported) >= 2, cell
        layers = spec.cell_metrics(BENCH, cell, True)
        assert layers, cell
        for m in layers:
            assert m["moves"] in reported and m["moves"] in e2e
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    wl = spec.load("workloads", cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"] and wl["why"] == entry["why"]
    assert entry["chips"] == 1
    spec.module("drivers", wl["driver"])
    for m in spec.cell_metrics(BENCH, cell, False) + spec.cell_metrics(BENCH, cell, True):
        assert callable(spec.module("metrics", m["name"]).read)
    for key in ("token_gap", "frame_flips"):
        assert wl["check"][key] > 0


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_load(entry):
    from port_bench import port

    cfg = spec.load("configs", entry["name"])
    assert entry["file"] == f"port_bench/configs/{entry['name']}.json"
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    mcfg, ccfg = port.configs(cfg)
    assert (mcfg.d_model, mcfg.dec_layers, mcfg.lt_dim, ccfg.base_channels) == (768, 12, 256, 864)
    assert cfg["dtype"] in port.DTYPES


def test_kernels_found_by_file():
    kernels = spec.kernels()
    assert set(kernels) >= {"A", "B", "C"}
    for mod in kernels.values():
        assert callable(mod.info) and callable(mod.least_seconds) and len(mod.SITE) == 2


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    """A copy of the folder with one more cell file, one more metric file and
    their entries in BENCHMARK.json: the harness runs it with no edit."""
    root = tmp_path / "port_bench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    src = json.loads((root / "workloads" / "serve-bf16-short.json").read_text())
    src.update(name="serve-bf16-extra", why="a cell added by files only")
    (root / "workloads" / "serve-bf16-extra.json").write_text(json.dumps(src))
    (root / "metrics" / "requests_done.extra.py").write_text(
        "def read(run):\n    return float(run.win['counts']['requests'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "serve-bf16-extra", "config": "magpie357m-bf16",
                               "traffic": "extra", "chips": 1, "why": "added by files only"})
    bench["end_to_end"][0]["workloads"].append("serve-bf16-extra")
    bench["per_layer"].append({"name": "requests_done.extra", "unit": "req", "better": "higher",
                               "source": "host_clock", "layer": "engine", "moves": "throughput_fps",
                               "workloads": ["serve-bf16-extra"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.load("workloads", "serve-bf16-extra", root)["why"] == "a cell added by files only"
    res = run.run_cell("serve-bf16-extra", 5, 2.0, True, device="cpu", root=root,
                       overrides=tiny.overrides("serve-bf16-extra", root))
    res.pop("_run")
    assert "requests_done.extra" in res["metrics"]
    assert res["metrics"]["requests_done.extra"]["unit"] == "req"
