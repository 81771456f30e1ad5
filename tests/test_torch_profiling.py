"""The port's profiling utilities (``utils/profiling.py``) and its
compilation cache (``utils/cache.py``), on the CPU.

``count_parameters`` equals the JAX package's on the same small model (both
count every stored leaf, bn0's running statistics included; a module's
trainable count, the reference's, leaves those out). ``count_flops``
equals 2 x the multiply-adds reckoned from the config and the layers'
output shapes, in the f32 parity config (plain products and convolutions)
and in the bf16 serving config (the fused block's registered formula). The
JAX package's figure comes from XLA's cost analysis, which also counts
elementwise work: the ratio is printed, not asserted.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audioset_convnext_inf_tpu.config import ConvNeXtConfig as JaxConfig
from audioset_convnext_inf_tpu.models import convnext as JM
from audioset_convnext_inf_tpu.utils import profiling as JP

from audioset_convnext_inf_torch.config import ConvNeXtConfig
from audioset_convnext_inf_torch.models import ConvNeXt
from audioset_convnext_inf_torch.models import convnext as F
from audioset_convnext_inf_torch.ops import _build
from audioset_convnext_inf_torch.utils import cache, host_build, native
from audioset_convnext_inf_torch.utils import profiling as P

from tests.test_torch_checkpoint import _port_init
from tests.test_torch_model import SMALL

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_count_parameters_matches_jax():
    cfg = ConvNeXtConfig(**SMALL)
    model = ConvNeXt(cfg, device="cpu")
    params = _port_init(cfg, 0)
    assert P.count_parameters(model.state_dict()) == JP.count_parameters(params) == 1173039
    m = cfg.frontend.n_mels
    assert P.count_parameters(model) == model.count_parameters() == 1173039 - 2 * m
    assert P.count_parameters([np.zeros((3, 4)), torch.zeros(5)]) == 17


def _macs(model, wave, cfg):
    """Multiply-adds of one forward, reckoned from the config and the
    layers' output shapes (the forward's ``tap``)."""
    shapes = {}
    with torch.inference_mode():
        x = F._frontend_and_bn0(model, model._waveform(wave), cfg, model.frontend,
                                model.compute_dtype)
        F.forward_features(model, x, cfg, tap=lambda k, v: shapes.setdefault(k, v.shape))
    fe = cfg.frontend
    b, t = x.shape[0], x.shape[1]
    nf = fe.n_fft // 2 + 1
    taps = -(-fe.n_fft // fe.hop_length)
    macs = b * t * 2 * nf * fe.hop_length * taps  # the conv DFT over hop-sized blocks
    macs += b * t * nf * fe.n_mels  # the mel product
    (kh, kw), _, _ = cfg.stem_geometry()
    bs, hs, ws, c = shapes["stem"]
    macs += bs * hs * ws * c * kh * kw
    dims = cfg.dims
    for i in range(4):
        if i:
            bd, hd, wd, cd = shapes[f"downsample {i}"]
            macs += bd * hd * wd * cd * dims[i - 1] * 4
        for j in range(cfg.depths[i]):
            key = next(k for k in shapes if k.startswith(f"stage {i + 1} block {j}"))
            bb, hb, wb, cb = shapes[key]
            macs += bb * hb * wb * cb * (49 + 8 * cb)
    return macs + b * dims[-1] * cfg.num_classes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_count_flops_is_twice_the_reckoned_macs(dtype):
    cfg = ConvNeXtConfig(**SMALL)
    model = ConvNeXt(cfg, device="cpu", compute_dtype=dtype)
    wave = np.random.RandomState(0).randn(2, 16000).astype(np.float32) * 0.1
    got = P.count_flops(model.forward, wave)
    assert got["flops"] == 2 * _macs(model, wave, model.cfg)
    assert sum(got["flops_by_op"].values()) == got["flops"]
    fused = "audioset_convnext_inf_torch.fused_block"
    assert (fused in got["flops_by_op"]) == (dtype == torch.bfloat16)
    if dtype == torch.bfloat16:
        return
    params = _port_init(cfg, 0)
    xla = JP.count_flops(lambda p, w: JM.forward(p, w, JaxConfig(**SMALL)), params, wave)
    print(f"{dtype}: port {got['flops']:.4e} FLOPs, XLA cost analysis {xla.get('flops', 0):.4e} "
          f"(ratio {got['flops'] / max(xla.get('flops', 1), 1):.3f})")


def test_profile_ops_and_trace_on_the_cpu(tmp_path):
    cfg = ConvNeXtConfig(**SMALL)
    model = ConvNeXt(cfg, device="cpu")
    wave = np.random.RandomState(1).randn(2, 16000).astype(np.float32)
    rows = P.profile_ops(model.forward, wave, iters=2)
    assert rows and all(set(r) == {"name", "category", "ms_per_iter", "count_per_iter",
                                   "long_name"} for r in rows)
    assert [r["ms_per_iter"] for r in rows] == sorted((r["ms_per_iter"] for r in rows),
                                                      reverse=True)
    by_name = {r["name"]: r for r in rows}
    assert by_name["aten::gelu"]["count_per_iter"] == sum(cfg.depths)
    assert all(r["category"] == "cpu_op" and not r["name"].startswith("ProfilerStep")
               for r in rows)
    with P.trace(str(tmp_path / "t")) as d:
        model.forward(wave)
    events = json.loads((Path(d) / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::gelu" for e in events)
    assert P._kernel_short_name("void ns::k<(int)3, true>(float const*, int)") == "ns::k"


@pytest.fixture
def fresh_cache(monkeypatch):
    """enable_compilation_cache's state and the two build directories,
    restored after the test."""
    monkeypatch.setattr(cache, "_ENABLED", False)
    monkeypatch.setattr(host_build, "BUILD_DIR", host_build.BUILD_DIR)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.delenv("AUDIOSET_TPU_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("AUDIOSET_TPU_NO_COMPILE_CACHE", raising=False)
    return monkeypatch


def test_compilation_cache_settings(fresh_cache, tmp_path):
    default_host, default_kernels = host_build.BUILD_DIR, _build.BUILD_DIR
    assert default_host == ROOT / "build" / "host_libs"
    assert default_kernels == ROOT / "build" / "torch_kernels"
    fresh_cache.setenv("AUDIOSET_TPU_NO_COMPILE_CACHE", "1")
    fresh_cache.setenv("AUDIOSET_TPU_COMPILE_CACHE", str(tmp_path))
    assert cache.enable_compilation_cache() is False
    assert host_build.BUILD_DIR == default_host and _build.BUILD_DIR == default_kernels
    fresh_cache.delenv("AUDIOSET_TPU_COMPILE_CACHE")
    fresh_cache.delenv("AUDIOSET_TPU_NO_COMPILE_CACHE")
    assert cache.enable_compilation_cache() is True  # the default: build/ stays
    assert host_build.BUILD_DIR == default_host and _build.BUILD_DIR == default_kernels


def test_compilation_cache_directory_is_shared(fresh_cache, tmp_path):
    """Under AUDIOSET_TPU_COMPILE_CACHE the host library builds into the
    directory, under the name the checkout's own build has (hash of source
    and flags); a second process loads it without building."""
    name = native.library_path().name
    fresh_cache.setenv("AUDIOSET_TPU_COMPILE_CACHE", str(tmp_path / "cc"))
    assert cache.enable_compilation_cache() is True
    assert host_build.BUILD_DIR == tmp_path / "cc" / "host_libs"
    assert _build.BUILD_DIR == tmp_path / "cc" / "torch_kernels"
    assert _build.library_path("fused_block").parent == tmp_path / "cc" / "torch_kernels"
    built = native.build()
    assert built == tmp_path / "cc" / "host_libs" / name and native.available()
    stamp = built.stat().st_mtime_ns
    code = ("from audioset_convnext_inf_torch.utils import cache, native\n"
            "assert cache.enable_compilation_cache()\n"
            "import numpy as np\n"
            "native.int16_to_float32(np.ones(3, np.int16))\n"
            "print(native.library_path())\n")
    env = dict(os.environ, AUDIOSET_TPU_COMPILE_CACHE=str(tmp_path / "cc"),
               PATH=str(tmp_path))  # no compiler: a build would fail
    env.pop("CXX", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == str(built), proc.stderr[-2000:]
    assert built.stat().st_mtime_ns == stamp
