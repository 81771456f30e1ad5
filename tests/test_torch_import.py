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
)


def test_sources_name_neither_jax_nor_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu"))
    assert len(files) >= 10
    assert {PKG / m for m in SERVING_AND_TRAINING} <= set(files)
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
                                                 extract_embeddings, serve, train)
    from audioset_convnext_inf_torch.engine.evaluator import Evaluator
    from audioset_convnext_inf_torch.models import api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.convnext_tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.create_model("convnext_atto")
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
                       (["--train-indexes", "i.h5", "--workspace", out], train.main)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    assert not list(tmp_path.iterdir())  # nothing was written
    from audioset_convnext_inf_torch.engine.aot_export import save_bundle

    bundle = str(tmp_path / "cpu_bundle")  # a bundle exported for the CPU
    save_bundle(model, bundle, batch_sizes=(1,), num_samples=16000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--port", "0", "--bundle", bundle])


def test_the_port_loads_no_native_library():
    """The JAX package's native data plane (``native/libaudiohost.so``) is
    built on demand by ``make``; the port reads audio with numpy and scipy."""
    for f in sorted(PKG.rglob("*.py")):
        text = f.read_text()
        assert "libaudiohost" not in text and "audio_host" not in text, f


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
