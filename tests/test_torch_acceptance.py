"""PyTorch port, the acceptance tooling on the CPU: the port's dump_golden
against the JAX package's tools/dump_golden.py on a tiny GGUF written by the
port's writer, both packages' verify_golden over the two trees, and the
port's acceptance checklist passing on the JAX tool's tree and failing where
it must."""

import shutil
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from magpie_tts_tpu_torch.io.golden import read_golden, write_golden
from magpie_tts_tpu_torch.tools import acceptance, dump_golden, verify_golden
from tests.utils import tiny_codec_config, tiny_magpie_config

TEXT = "hello world"
FRAMES = 4
EXACT = ("tokens", "greedy_codes", "lt_greedy_codes", "codec_latent")


def _bar(name: str) -> float:
    """Tokens and codes exact, codec intermediates 5e-5, float32 traces 1e-5."""
    if name in EXACT:
        return 0.0
    return 5e-5 if name.startswith("codec") else 1e-5


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_acceptance")
    paths = {"model": str(root / "magpie.gguf"), "q8": str(root / "magpie_q8.gguf"),
             "codec": str(root / "codec.gguf"), "root": root,
             "ref": str(root / "reference"), "cand": str(root / "candidate")}
    chip_smoke.write_model_gguf(paths["model"], tiny_magpie_config(), seed=7)
    chip_smoke.write_model_gguf(paths["q8"], tiny_magpie_config(), seed=7, quant="q8_0")
    chip_smoke.write_codec_gguf(paths["codec"], tiny_codec_config(), seed=7)
    from tools import dump_golden as jax_dump_golden

    argv = sys.argv
    sys.argv = ["dump_golden.py", "-m", paths["model"], "-c", paths["codec"], "-t", TEXT,
                "-o", paths["ref"], "--frames", str(FRAMES)]
    try:
        jax_dump_golden.main()
    finally:
        sys.argv = argv
    assert dump_golden.main(["-m", paths["model"], "-c", paths["codec"], "-t", TEXT,
                             "-o", paths["cand"], "--frames", str(FRAMES),
                             "--device", "cpu"]) == 0
    return paths


def test_dump_trees_agree_within_the_bars(trees):
    from pathlib import Path

    ref = sorted(p.stem for p in Path(trees["ref"]).glob("*.bin"))
    cand = sorted(p.stem for p in Path(trees["cand"]).glob("*.bin"))
    assert ref == cand and "codec_audio" in ref and "decoder_layer_1" in ref
    for name in ref:
        a = read_golden(f"{trees['ref']}/{name}.bin")
        b = read_golden(f"{trees['cand']}/{name}.bin")
        assert a.shape == b.shape, name
        err = float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0
        assert err <= _bar(name), (name, err)
    codes = read_golden(f"{trees['cand']}/greedy_codes.bin")
    assert codes.shape == (FRAMES, 8)


def test_both_compare_dirs_pass(trees):
    from tools.verify_golden import compare_dirs as jax_compare_dirs

    for compare in (verify_golden.compare_dirs, jax_compare_dirs):
        n_ok, n_fail, n_missing, lines = compare(trees["ref"], trees["cand"])
        assert (n_fail, n_missing) == (0, 0), lines
        assert n_ok == len(lines) > 30


def test_verify_golden_cli_exit_codes(trees, tmp_path, capsys):
    assert verify_golden.main([trees["ref"], trees["cand"]]) == 0
    out = capsys.readouterr().out
    assert "0 failed, 0 missing" in out
    bad = tmp_path / "bad"
    shutil.copytree(trees["cand"], bad)
    (bad / "xa_k.bin").unlink()
    write_golden(str(bad / "decoder_output.bin"),
                 read_golden(str(bad / "decoder_output.bin")) + 0.01)
    assert verify_golden.main([trees["ref"], str(bad), "-q"]) == 1
    out = capsys.readouterr().out
    assert "MISSING  xa_k" in out and "FAIL" in out and "decoder_output" in out
    # an override loosens one prefix
    write_golden(str(bad / "xa_k.bin"), read_golden(f"{trees['cand']}/xa_k.bin"))
    assert verify_golden.main([trees["ref"], str(bad), "--tol", "decoder_output=0.02"]) == 0
    empty = tmp_path / "empty"
    empty.mkdir()
    assert verify_golden.main([str(empty), trees["cand"]]) == 2


def _acceptance(trees, *extra):
    return acceptance.main(["-m", trees["model"], "-c", trees["codec"], "-t", TEXT,
                            "--max-frames", str(FRAMES), "--device", "cpu", *extra])


def test_acceptance_passes_on_the_jax_tree(trees, capsys):
    first = read_golden(f"{trees['ref']}/greedy_codes.bin")[0].astype(int).tolist()
    rc = _acceptance(trees, "-r", trees["ref"], "--first-frame", ",".join(map(str, first)))
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "ACCEPTANCE: PASS" in out
    for stage in ("load_model", "load_codec", "tokens", "greedy_codes_e2e",
                  "first_frame_codes", "per_layer_goldens", "audio_synthesis"):
        assert any(line.split()[:2] == ["ok", stage] for line in out.splitlines()), stage


def test_acceptance_fails_on_a_perturbed_golden(trees, capsys):
    bad = trees["root"] / "reference_bad"
    shutil.copytree(trees["ref"], bad, dirs_exist_ok=True)
    golden = bad / "encoder_layer_0.bin"
    write_golden(str(golden), read_golden(str(golden)) + 0.1)   # past the 8e-3 bar
    rc = _acceptance(trees, "-r", str(bad))
    out = capsys.readouterr().out
    assert rc == 1
    assert "ACCEPTANCE: FAIL" in out and "FAIL     encoder_layer_0" in out


def test_acceptance_fails_on_a_wrong_first_frame(trees, capsys):
    first = read_golden(f"{trees['ref']}/greedy_codes.bin")[0].astype(int)
    rc = _acceptance(trees, "-r", trees["ref"],
                     "--first-frame", ",".join(map(str, (first + 1).tolist())))
    out = capsys.readouterr().out
    assert rc == 1
    assert any(line.split()[:2] == ["FAIL", "first_frame_codes"] for line in out.splitlines())


def test_acceptance_q8_native_stage(trees, capsys):
    """On a Q8_0 file, stage 3b serves the file's own blocks and must give
    the dequantize-at-load greedy codes exactly; on a float32 file it skips."""
    rc = acceptance.main(["-m", trees["q8"], "-t", TEXT, "--max-frames", "6",
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    line = [ln for ln in out.splitlines() if "q8_native_codes" in ln][0]
    assert line.split()[0] == "ok" and "6 frames exactly equal" in line
    assert _acceptance(trees) == 0
    out = capsys.readouterr().out
    assert "skip  q8_native_codes" in out and "skip  per_layer_goldens" in out


def test_tools_default_to_cuda_and_raise_without_it(trees, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        acceptance.main(["-m", trees["model"], "-t", TEXT])
    with pytest.raises(RuntimeError, match="CUDA"):
        dump_golden.main(["-m", trees["model"], "-o", str(trees["root"] / "never")])
    assert not (trees["root"] / "never").exists()
