"""The port stands alone: it imports without JAX and without the JAX
package, names neither in its sources, and runs on the card unless the
caller asks for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import audioset_convnext_inf_torch
from audioset_convnext_inf_torch.ops import _build

PKG = Path(audioset_convnext_inf_torch.__file__).resolve().parent
ROOT = PKG.parent


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "audioset_convnext_inf_torch."))


def test_imports_with_jax_blocked():
    mods = _submodules()
    assert "audioset_convnext_inf_torch.ops.fused_block" in mods
    assert {f"audioset_convnext_inf_torch.{m}" for m in (
        "version", "utils.native", "utils.host_build", "utils.profiling", "utils.cache",
        "ops.kaldi_fbank", "data.pack", "cli.pack_dataset")} <= set(mods)
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'optax', 'audioset_convnext_inf_tpu', 'h5py', 'sklearn',\n"
        "             'safetensors', 'wandb'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax',"
        " 'audioset_convnext_inf_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


SERVING_AND_TRAINING = (
    "cli/serve.py", "cli/train.py", "data/blacklist.py", "data/samplers.py",
    "engine/service.py", "engine/statistics.py", "engine/trainer.py", "checkpoint/io.py",
    "labels.py", "utils/logging_utils.py", "engine/aot_export.py", "cli/export_serving.py",
    "data/audiocaps.py", "data/flac.py", "engine/transfer.py", "cli/finetune_audiocaps.py",
    "version.py", "utils/native.py", "utils/host_build.py", "utils/profiling.py",
    "utils/cache.py", "ops/kaldi_fbank.py", "data/pack.py", "cli/pack_dataset.py",
)


def test_sources_name_neither_jax_nor_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) + sorted(PKG.rglob("*.cpp"))
    assert len(files) >= 10
    assert {PKG / m for m in SERVING_AND_TRAINING} | {PKG / "csrc" / "flac_decode.cpp",
                                                       PKG / "csrc" / "audio_host.cpp"} <= set(files)
    for f in files:
        text = f.read_text()
        assert "audioset_convnext_inf_tpu" not in text, f
        if f.suffix == ".py":
            for node in ast.walk(ast.parse(text)):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "optax")], f


def test_entry_points_need_the_card_or_an_explicit_cpu(monkeypatch, tmp_path):
    from audioset_convnext_inf_torch.cli import (convert, demo, evaluate, export_serving,
                                                 extract_embeddings, finetune_audiocaps,
                                                 inference, serve, train)
    from audioset_convnext_inf_torch.engine.evaluator import Evaluator
    from audioset_convnext_inf_torch.models import api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.convnext_tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.create_model("convnext_atto")
    from audioset_convnext_inf_torch.models import create_pann_model

    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_pann_model("Cnn6")
    assert create_pann_model("LeeNet11", device="cpu").device == torch.device("cpu")
    assert api.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.ConvNeXt.from_pretrained(str(tmp_path / "ckpt.safetensors"))
    model = api.convnext_atto(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator(model)
    with pytest.raises(ValueError, match="lives on"):
        Evaluator(model, device="cuda")
    wav = str(ROOT / "tests" / "fixtures" / "f62-S-v2swA_200000_210000.wav")
    out = str(tmp_path / "out")
    for argv, main in ((["--checkpoint", "c.pth", "--eval-indexes", "i.h5"], evaluate.main),
                       ([wav], demo.main),
                       ([wav, "--out", out + ".h5"], extract_embeddings.main),
                       (["c.safetensors", out], convert.main),
                       (["--port", "0"], serve.main),
                       ([out], export_serving.main),
                       (["--train-indexes", "i.h5", "--workspace", out], train.main),
                       (["audio_tagging", "--audio-path", wav], inference.main),
                       (["--root", out, "--out-dir", out], finetune_audiocaps.main),
                       (["sound_event_detection", "--audio-path", wav, "--out-csv",
                         out + ".csv", "--model-type", "Cnn14_DecisionLevelMax"],
                        inference.main)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    assert not list(tmp_path.iterdir())  # nothing was written
    from audioset_convnext_inf_torch.engine.aot_export import save_bundle

    bundle = str(tmp_path / "cpu_bundle")  # a bundle exported for the CPU
    save_bundle(model, bundle, batch_sizes=(1,), num_samples=16000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--port", "0", "--bundle", bundle])


def test_the_port_loads_no_native_library():
    """The JAX package's native data plane (``native/libaudiohost.so``, built
    by ``make`` in ``native/``) is not the port's: the port builds its own
    copies of the sources (``csrc/audio_host.cpp``, ``csrc/flac_decode.cpp``)
    into libraries of its own, no source of the port names the JAX library,
    and a process that decodes WAV, int16 and FLAC and resamples through the
    port has not mapped it."""
    for f in sorted(PKG.rglob("*.py")):
        assert "libaudiohost" not in f.read_text(), f
    from audioset_convnext_inf_torch.data import flac
    from audioset_convnext_inf_torch.utils import native

    assert native.SOURCE == PKG / "csrc" / "audio_host.cpp"
    assert flac.SOURCE == PKG / "csrc" / "flac_decode.cpp"
    assert native.library_path().name.startswith("libaudio_host_")
    code = (
        "import numpy as np\n"
        "from audioset_convnext_inf_torch.data import audio_io\n"
        "from audioset_convnext_inf_torch.data.flac import decode_flac_bytes\n"
        "x, sr = audio_io.read_wav('tests/fixtures/f62-S-v2swA_200000_210000.wav', 16000)\n"
        "audio_io.int16_to_float32(np.zeros(8, np.int16))\n"
        "try:\n"
        "    decode_flac_bytes(b'fLaC')\n"
        "except ValueError:\n"
        "    pass\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libaudio_host_' in maps and 'libflac_decode_' in maps\n"
        "print('libaudiohost' in maps)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "False", proc.stderr[-2000:]


def test_kernel_modules_import_and_run_on_cpu_without_nvcc():
    code = (
        "import torch\n"
        "from audioset_convnext_inf_torch.ops import _build, fused_block as FB\n"
        "assert _build.find_nvcc() is None\n"
        "c = 8\n"
        "x = torch.randn(1, 5, 5, c)\n"
        "w = [torch.randn(c, 1, 7, 7), torch.zeros(c), torch.ones(c), torch.zeros(c),\n"
        "     torch.randn(4 * c, c), torch.zeros(4 * c), torch.randn(c, 4 * c), torch.zeros(c), None]\n"
        "assert FB.fused_block(x, *w).shape == x.shape and FB.fused_block.launches == 0\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc at its default path")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("fused_block")
    name = _build.library_path("fused_block").name
    assert name.startswith("libfused_block_") and name.endswith(".so")


def test_flac_build_without_a_compiler_raises(monkeypatch, tmp_path):
    from audioset_convnext_inf_torch.data import flac

    monkeypatch.setattr(flac, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        flac.build()
    monkeypatch.setenv("CXX", sys.executable)  # a "compiler" that fails
    monkeypatch.setenv("PATH", os.path.dirname(sys.executable))
    with pytest.raises(RuntimeError, match="building the FLAC decoder failed"):
        flac.build()
    assert not list(tmp_path.glob("*.so"))
