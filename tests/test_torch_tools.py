"""PyTorch port, the checkpoint tools (``magpie_tts_tpu_torch.tools``:
``convert_nemo_to_gguf``, ``convert_codec_to_gguf``, ``inspect_gguf``,
``dump_reference_nemo``) against the JAX package's tools/ scripts, on the
synthetic ``.nemo`` tarballs of tests/test_tools.py. Tolerance: none: the
GGUF files and the golden ``.bin`` files must be byte-equal to the JAX
tools', ``inspect_gguf`` must print the same lines, and each tool must run
as ``python -m magpie_tts_tpu_torch.tools.<name>`` with jax and the JAX
package unimportable."""

import io
import os
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from magpie_tts_tpu_torch.io import gguf
from magpie_tts_tpu_torch.io.golden import read_golden
from magpie_tts_tpu_torch.tools import convert_codec_to_gguf as codec_tool
from magpie_tts_tpu_torch.tools import convert_nemo_to_gguf as nemo_tool
from magpie_tts_tpu_torch.tools import dump_reference_nemo as dumper
from tools import convert_codec_to_gguf as jax_codec_tool
from tools import convert_nemo_to_gguf as jax_nemo_tool
from tools import dump_reference_nemo as jax_dumper

REPO = Path(__file__).resolve().parent.parent
# Makes jax and the JAX package unimportable, then runs a module as __main__.
NO_JAX = ("import runpy, sys\n"
          "for m in ('jax', 'jaxlib', 'flax', 'magpie_tts_tpu'): sys.modules[m] = None\n"
          "sys.argv = sys.argv[1:]\n"
          "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n")


def _write_fake_nemo(path, tensors: dict, config_yaml: str = "model: {}\n"):
    """A .nemo-style tar (model_config.yaml + model_weights.ckpt), as
    tests/test_tools.py builds it."""
    buf = io.BytesIO()
    torch.save({k: torch.from_numpy(v) for k, v in tensors.items()}, buf)
    ckpt = buf.getvalue()
    with tarfile.open(path, "w") as tar:
        for name, data in (("./model_config.yaml", config_yaml.encode()),
                           ("./model_weights.ckpt", ckpt)):
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tar.addfile(ti, io.BytesIO(data))


def _magpie_tensors():
    rng = np.random.default_rng(21)
    return {
        "text_embedding.weight": rng.normal(size=(10, 8)).astype(np.float32),
        "encoder.layers.0.self_attention.qkv_net.weight":
            rng.normal(size=(96, 32)).astype(np.float32),
        "decoder.layers.1.pos_ff.proj.conv.weight": rng.normal(size=(64, 32, 1))
        .astype(np.float32),
        "local_transformer_out_projections.3.weight": rng.normal(size=(40, 32))
        .astype(np.float32),
        "encoder.layers.0.norm_self.weight": rng.normal(size=(32,)).astype(np.float32),
        "magpie_codec_model.some.weight": rng.normal(size=(4, 4)).astype(np.float32),
        "final_proj.bias": rng.normal(size=(16,)).astype(np.float32),
        "final_proj.weight": rng.normal(size=(16, 8)).astype(np.float32),  # < 256: f32
    }


def _codec_tensors():
    rng = np.random.default_rng(22)
    v = rng.normal(size=(6, 4, 3)).astype(np.float32)
    g = rng.uniform(0.5, 2.0, size=(6, 1, 1)).astype(np.float32)
    return {
        "audio_decoder.pre_conv.conv.parametrizations.weight.original0": g,
        "audio_decoder.pre_conv.conv.parametrizations.weight.original1": v,
        "audio_decoder.pre_conv.conv.bias": rng.normal(size=(6,)).astype(np.float32),
        "audio_decoder.res_layers.0.res_blocks.1.res_blocks.2.input_activation.activation"
        ".snake_act.alpha": rng.uniform(size=(1, 4, 1)).astype(np.float32),
        "vector_quantizer.fsqs.0.dim_base_index":
            np.array([1, 8, 56, 336], np.float32).reshape(1, 4, 1),
        "discriminator.should_be_dropped": rng.normal(size=(3,)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def nemo_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("nemo")
    _write_fake_nemo(str(d / "m.nemo"), _magpie_tensors())
    _write_fake_nemo(str(d / "c.nemo"), _codec_tensors())
    (d / "vocab.txt").write_text("a\nb\nc\n", encoding="utf-8")
    (d / "dict.txt").write_text("hello HH AH0 L OW1\nworld W ER1 L D\n", encoding="utf-8")
    return d


@pytest.mark.parametrize("quant", [None, "q8_0", "q4_0", "f16"])
def test_magpie_converter_bytes_equal_jax(nemo_files, tmp_path, quant):
    d = nemo_files
    for mod, out in ((nemo_tool, "port.gguf"), (jax_nemo_tool, "jax.gguf")):
        mod.convert(str(d / "m.nemo"), str(tmp_path / out), quant=quant,
                    vocab_path=str(d / "vocab.txt"), dict_path=str(d / "dict.txt"))
    port = (tmp_path / "port.gguf").read_bytes()
    assert port == (tmp_path / "jax.gguf").read_bytes()
    r = gguf.GGUFReader(str(tmp_path / "port.gguf"))
    assert "magpie_codec_model.some.weight" not in r.tensors       # skipped
    assert r.metadata["magpie.d_model"] == 768
    assert r.metadata["magpie.tokenizer.vocab"] == "a\nb\nc"
    qkv = r.tensors["encoder.layers.0.self_attention.qkv_net.weight"].ggml_type
    assert qkv == {None: gguf.GGML_F32, "q8_0": gguf.GGML_Q8_0, "q4_0": gguf.GGML_Q4_0,
                   "f16": gguf.GGML_F16}[quant]
    assert r.tensors["final_proj.bias"].ggml_type == gguf.GGML_F32  # norms / biases stay f32


@pytest.mark.parametrize("f16", [False, True])
def test_codec_converter_bytes_equal_jax(nemo_files, tmp_path, f16):
    codec_tool.convert(str(nemo_files / "c.nemo"), str(tmp_path / "port.gguf"), f16)
    jax_codec_tool.convert(str(nemo_files / "c.nemo"), str(tmp_path / "jax.gguf"), f16)
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "jax.gguf").read_bytes()


def test_codec_converter_weight_norm_folding(nemo_files, tmp_path):
    t = _codec_tensors()
    g = t["audio_decoder.pre_conv.conv.parametrizations.weight.original0"]
    v = t["audio_decoder.pre_conv.conv.parametrizations.weight.original1"]
    codec_tool.convert(str(nemo_files / "c.nemo"), str(tmp_path / "c.gguf"))
    r = gguf.GGUFReader(str(tmp_path / "c.gguf"))
    assert {"dec.pre.weight", "dec.pre.bias", "vq.fsqs.0.dim_base_index",
            "dec.rl.0.rb.1.rb.2.in_act.alpha"} <= set(r.tensors)
    assert not any("discriminator" in n or "parametrizations" in n for n in r.tensors)
    expect = g * v / np.sqrt(np.sum(v ** 2, axis=(1, 2), keepdims=True) + 1e-12)
    np.testing.assert_allclose(r.tensor("dec.pre.weight"), expect, atol=1e-6)
    folded = codec_tool.fold_weight_norm(t)
    want = jax_codec_tool.fold_weight_norm(t)
    assert sorted(folded) == sorted(want)
    for k in want:
        assert folded[k].tobytes() == want[k].tobytes()


@pytest.mark.parametrize("name", [
    "audio_decoder.res_layers.0.res_blocks.1.res_blocks.2.input_activation.activation"
    ".snake_act.alpha",
    "audio_decoder.up_sample_conv_layers.3.conv.weight",
    "audio_decoder.res_layers.2.res_blocks.0.res_blocks.1.skip_conv.conv.bias",
    "audio_decoder.post_activation.activation.snake_act.beta",
    "vector_quantizer.fsqs.3.dim_base_index",
])
def test_codec_name_shortening_equals_jax(name):
    assert codec_tool.shorten_name(name) == jax_codec_tool.shorten_name(name)
    assert len(codec_tool.shorten_name(name)) <= 64
    assert codec_tool.shorten_name("audio_decoder.up_sample_conv_layers.3.conv.weight") == \
        "dec.up.3.c.weight"


def _hooked_model():
    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 4)

        def forward(self, x):
            return {"output": torch.relu(self.lin(x))}   # NeMo-style dict output

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = torch.nn.Linear(4, 4)
            self.layers = torch.nn.ModuleList([Block(), Block()])

        def forward(self, x):
            h = self.emb(x)
            for layer in self.layers:
                h = layer(h)["output"]
            return (h, None)                            # tuple output

    torch.manual_seed(0)
    return Model().eval()


def test_hook_dumper_bytes_equal_jax(tmp_path):
    """TensorCapture / dump_module_outputs write the JAX dumper's golden
    files byte for byte, and the goldens hold the modules' outputs."""
    model = _hooked_model()
    x = torch.randn(3, 4)
    patterns = ["emb", "layers.0", "layers.1", "", "missing"]
    written = dumper.dump_module_outputs(model, lambda m: m(x), patterns,
                                         str(tmp_path / "port"), quiet=True)
    jax_written = jax_dumper.dump_module_outputs(model, lambda m: m(x), patterns,
                                                 str(tmp_path / "jax"), quiet=True)
    assert written == jax_written and set(written) == {"emb", "layers.0", "layers.1", ""}
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    with torch.no_grad():
        h0 = model.layers[0](model.emb(x))["output"]
    np.testing.assert_allclose(read_golden(str(tmp_path / "port" / "layers_0.bin")),
                               h0.numpy(), atol=1e-7)
    assert dumper.DEFAULT_PATTERNS == jax_dumper.DEFAULT_PATTERNS
    assert dumper.safe_name("decoder.layers.11") == jax_dumper.safe_name("decoder.layers.11")
    cap = dumper.TensorCapture(model, ["emb"])
    cap.close()
    with torch.no_grad():
        model(x)
    assert cap.captures == {}


def test_nemo_loader_error_equals_jax():
    """Without NeMo, loading a checkpoint exits with the JAX tool's message."""
    try:
        import nemo  # noqa: F401
        pytest.skip("NeMo is installed")
    except ImportError:
        pass
    msgs = []
    for mod in (dumper, jax_dumper):
        with pytest.raises(SystemExit) as e:
            mod.load_nemo_magpie("missing.nemo")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "NeMo is not installed" in msgs[0]


def _run(args, no_jax=False, timeout=120):
    cmd = [sys.executable, "-c", NO_JAX] + args if no_jax else [sys.executable] + args
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=timeout,
                          env=env)


@pytest.mark.parametrize("stats", [False, True])
def test_inspect_gguf_prints_the_jax_tools_lines(tmp_path, stats):
    from tests import fixtures

    path = str(tmp_path / "m.gguf")
    fixtures.write_tiny_magpie_gguf(path, quant="q8_0")
    extra = ["--stats"] if stats else []
    port = _run(["magpie_tts_tpu_torch.tools.inspect_gguf", path] + extra, no_jax=True)
    ref = _run(["tools/inspect_gguf.py", path] + extra)
    assert port.returncode == 0 and ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout == ref.stdout
    assert "text_embedding.weight" in port.stdout and "Q8_0" in port.stdout


def test_converters_run_without_jax(nemo_files, tmp_path):
    """``python -m`` of each converter with jax unimportable; the files equal
    the in-process JAX tools' output."""
    d = nemo_files
    port = _run(["magpie_tts_tpu_torch.tools.convert_nemo_to_gguf", str(d / "m.nemo"),
                 str(tmp_path / "m.gguf"), "-q", "q8_0", "--vocab", str(d / "vocab.txt"),
                 "--dict", str(d / "dict.txt")], no_jax=True)
    assert port.returncode == 0, port.stderr
    assert "f32 + " in port.stderr and "quantized tensors" in port.stderr
    jax_nemo_tool.convert(str(d / "m.nemo"), str(tmp_path / "want.gguf"), "q8_0",
                          str(d / "vocab.txt"), str(d / "dict.txt"))
    assert (tmp_path / "m.gguf").read_bytes() == (tmp_path / "want.gguf").read_bytes()
    port = _run(["magpie_tts_tpu_torch.tools.convert_codec_to_gguf", str(d / "c.nemo"),
                 str(tmp_path / "c.gguf"), "--f16"], no_jax=True)
    assert port.returncode == 0, port.stderr
    jax_codec_tool.convert(str(d / "c.nemo"), str(tmp_path / "cw.gguf"), True)
    assert (tmp_path / "c.gguf").read_bytes() == (tmp_path / "cw.gguf").read_bytes()


def test_dump_reference_nemo_runs_without_jax():
    """The dumper's CLI starts with jax unimportable and stops at the NeMo
    import with the JAX tool's message (no checkpoint, no NeMo here)."""
    try:
        import nemo  # noqa: F401
        pytest.skip("NeMo is installed")
    except ImportError:
        pass
    port = _run(["magpie_tts_tpu_torch.tools.dump_reference_nemo", "--model", "x.nemo"],
                no_jax=True)
    assert port.returncode == 1 and "NeMo is not installed" in port.stderr
    assert "jax" not in port.stderr.lower().replace("nemo_toolkit", "")
