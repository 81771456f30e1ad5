"""The port's AOT serving export (engine/aot_export.py) and its K1/K2
custom ops, on the CPU.

The JAX package's tests/test_aot_export.py contracts, for the port's
``torch.export`` bundles at the same sizes (depths (1,1,1,1), dims
(16,32,64,128), N=16000 samples, B=3): a program against the live model
(1e-6 on probabilities, as the JAX test; on the CPU the same ops in the same
order, so a program at the live batch is bit-equal), a save/load round trip
bit-equal, the pad-to-bucket contract, the kinds, shared weights, the
dynamic batch, the int16 entry point, the CLI and the service. Then the
port's programs against the JAX package's exported programs on carried
weights, a bundle loaded in a process that cannot import model code, and
``torch.library.opcheck`` on the three kernel ops. Exports and loads take
about a second each here, so the fixtures are few and module-wide.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioset_convnext_inf_tpu.config import ConvNeXtConfig as JaxConfig
from audioset_convnext_inf_tpu.engine.aot_export import export_serving as jax_export_serving
from audioset_convnext_inf_tpu.models import api as jax_api
from audioset_convnext_inf_tpu.models import convnext as JF

from audioset_convnext_inf_torch.checkpoint import jax_params_from_state_dict
from audioset_convnext_inf_torch.config import INT16_SCALE, ConvNeXtConfig
from audioset_convnext_inf_torch.engine.aot_export import (
    BundleModel,
    calls_k1,
    export_serving,
    load_bundle,
    save_bundle,
)
from audioset_convnext_inf_torch.models.api import ConvNeXt
from audioset_convnext_inf_torch.ops import fused_block as FB
from audioset_convnext_inf_torch.ops import fused_block_bwd as FBB

ROOT = Path(__file__).resolve().parents[1]
N = 16000  # short clips keep the CPU traces fast
SIZES = dict(name="aot_test", depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), drop_path_rate=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@torch.no_grad()
def _seeded(model: ConvNeXt) -> ConvNeXt:
    """Seeded gamma (0.1-1), biases and bn0 values: at init gamma is 1e-6
    and every block is nearly the identity."""
    g = torch.Generator().manual_seed(7)
    for name, t in model.state_dict().items():
        if name.endswith("gamma"):
            t.copy_(torch.rand(t.shape, generator=g) * 0.9 + 0.1)
        elif name.endswith("bias"):
            t.copy_(torch.randn(t.shape, generator=g) * 0.05)
    bn = model.bn0
    n = bn.weight.shape[0]
    bn.weight.copy_(torch.rand(n, generator=g) * 1.5 + 0.5)
    bn.running_mean.copy_(torch.randn(n, generator=g) * 5.0 - 40.0)
    bn.running_var.copy_(torch.rand(n, generator=g) * 150.0 + 50.0)
    return model


@pytest.fixture(scope="module")
def model():
    return _seeded(ConvNeXt(ConvNeXtConfig(**SIZES), device="cpu"))


@pytest.fixture(scope="module")
def bf16_model(model):
    """The bf16 trunk with tanh GELU, so stages 3-4 run the fused block op;
    frontend "highest" (tests/test_torch_model.py: the JAX package's CPU
    backend does not round its DFT to bf16)."""
    m = ConvNeXt(ConvNeXtConfig(**SIZES, block_impl="xla_approx"), compute_dtype=torch.bfloat16,
                 auto_fast_serving=False, device="cpu")
    m.load_state_dict(model.state_dict())
    return m


@pytest.fixture(scope="module")
def wav():
    rng = np.random.RandomState(0)
    return (rng.randn(3, N) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def pcm(wav):
    """The clips on the int16 wire grid, as BundleModel quantises them."""
    return np.clip(np.round(wav.astype(np.float64) * 32767.0), -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def exported(model):
    """The f32 forward program at B=2, in memory (``bundle`` holds the same
    program saved and loaded)."""
    return export_serving(model, 2, num_samples=N)


@pytest.fixture(scope="module")
def bundle(model, tmp_path_factory):
    """(directory, loaded bundle): f32 forward programs at buckets 2 and 4,
    weights baked in."""
    path = str(tmp_path_factory.mktemp("aot") / "bundle")
    save_bundle(model, path, batch_sizes=(2, 4), num_samples=N)
    return path, load_bundle(path, device="cpu")


@pytest.fixture(scope="module")
def shared(model, tmp_path_factory):
    """(directory, manifest, loaded bundle): int16 input, bucket 4, every
    kind, the weights once in params.npz."""
    path = str(tmp_path_factory.mktemp("aot") / "shared")
    manifest = save_bundle(model, path, batch_sizes=(4,), kinds=("forward", "scene", "frame"),
                           pcm=True, num_samples=N, weights="shared")
    return path, manifest, load_bundle(path, device="cpu")


@pytest.fixture(scope="module")
def cli_bundle(bf16_model, tmp_path_factory):
    """(exit code, directory, loaded bundle, the blocked process) of
    cli/export_serving.py on the README's bf16 serving recipe (int16 input;
    bucket 4 and a dynamic program), with the test's bf16 model. The
    process of test_bundle_loads_without_model_code starts here, so that
    its interpreter start and load overlap the tests between."""
    from audioset_convnext_inf_torch.cli import export_serving as cli
    import audioset_convnext_inf_torch.models.api as api

    tmp = tmp_path_factory.mktemp("aot")
    out = str(tmp / "cli_bundle")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(api, "create_model", lambda name, **kw: bf16_model)
        rc = cli.main([out, "--batch-sizes", "4,dynamic", "--num-samples", str(N), "--dtype",
                       "bfloat16", "--pcm", "--device", "cpu"])
    proc = _start_blocked_load(out, tmp)
    yield rc, out, load_bundle(out, device="cpu"), proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


BLOCKED = ("audioset_convnext_inf_torch.models", "audioset_convnext_inf_torch.checkpoint",
           "jax", "audioset_convnext_inf_tpu")
BLOCKED_PCM = (np.random.RandomState(2).randn(3, N) * 3000).astype(np.int16)  # bucket 4


def _start_blocked_load(bundle_dir: str, tmp: Path) -> subprocess.Popen:
    """A process in which BLOCKED cannot be imported: it loads the bundle,
    answers BLOCKED_PCM into ``tmp/out.npy`` and prints the port's modules
    and jax's that it imported."""
    np.save(tmp / "pcm.npy", BLOCKED_PCM)
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from audioset_convnext_inf_torch.engine.aot_export import load_bundle\n"
        f"out = load_bundle({bundle_dir!r}, device='cpu')(np.load({str(tmp / 'pcm.npy')!r}))\n"
        f"np.save({str(tmp / 'out.npy')!r}, out['clipwise_output'].float().numpy())\n"
        "print(sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and m.startswith(('audioset_convnext_inf_torch.', 'jax'))))\n"
    )
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _probs(out):
    return out["clipwise_output"].float().numpy()


def _run(program, x):
    """A program's module on ``x``, as ServingBundle runs it."""
    with torch.inference_mode():
        return program(torch.as_tensor(x))


def test_export_matches_live_model(model, exported, wav):
    out = _run(exported.module(), wav[:2])
    ref = model.forward(wav[:2])
    np.testing.assert_allclose(_probs(out), _probs(ref), atol=1e-6)
    np.testing.assert_allclose(out["clipwise_logits"].numpy(), ref["clipwise_logits"].numpy(),
                               atol=1e-5)
    # the same ops in the same order on the CPU
    assert torch.equal(out["clipwise_logits"], ref["clipwise_logits"])


def test_serialize_roundtrip_no_model_code(model, exported, bundle, wav):
    """``bundle``'s forward:2 is the same export, saved and loaded back."""
    again = _run(bundle[1]._programs["forward:2"], wav[:2])
    assert torch.equal(again["clipwise_output"],
                       _run(exported.module(), wav[:2])["clipwise_output"])
    np.testing.assert_allclose(_probs(again), _probs(model.forward(wav[:2])), atol=1e-6)


def test_bundle_pad_to_bucket_and_slice(model, bundle, wav):
    _, b = bundle
    assert b.manifest["param_count"] == model.count_parameters()
    # B=3 pads to bucket 4 and slices back
    out = b(wav)
    ref = model.forward(wav)
    assert out["clipwise_output"].shape == (3, 527)
    np.testing.assert_allclose(_probs(out), _probs(ref), rtol=0, atol=1e-6)
    # an exact bucket takes its program unpadded
    out2 = b(wav[:2])
    np.testing.assert_allclose(out2["clipwise_logits"].numpy(),
                               ref["clipwise_logits"].numpy()[:2], atol=1e-5)
    assert b.bucket_for(1) == 2 and b.bucket_for(4) == 4
    with pytest.raises(ValueError, match="exceeds"):
        b.bucket_for(5)
    with pytest.raises(ValueError):
        b(wav[:, : N // 2])


def test_bundle_kinds_and_manifest(model, shared, pcm):
    _, manifest, b = shared
    assert set(manifest["entries"]) == {"forward:4", "scene:4", "frame:4"}
    assert manifest["format"] == "audioset_convnext_inf_torch.aot_bundle.v1"
    assert manifest["device"] == "cpu" and manifest["fp32_precision"] == "highest"
    assert manifest["kernel_library"] is None and manifest["torch_version"] == torch.__version__
    emb = b(pcm, kind="scene")
    np.testing.assert_allclose(emb.numpy(), model.forward_scene_embeddings(pcm).numpy(),
                               atol=1e-5)
    frames = b(pcm, kind="frame")
    assert frames.shape == (3, 128, 1, 7)
    np.testing.assert_allclose(frames.numpy(), model.forward_frame_embeddings(pcm).numpy(),
                               atol=1e-5)


def test_shared_weights_bundle(model, bundle, shared, pcm):
    """weights='shared' stores the weights once (params.npz) beside small
    programs that take them; they answer as a baked bundle does, bit for
    bit: the int16 program against the f32 one fed the PCM decoded as the
    int16 program decodes it."""
    baked_dir, baked = bundle
    shared_dir, _, b = shared
    baked_prog = os.path.getsize(os.path.join(baked_dir, "forward_b4.pt2"))
    shared_prog = os.path.getsize(os.path.join(shared_dir, "forward_b4.pt2"))
    # both hold the frontend's constants, which dominate at this width
    param_bytes = sum(p.numel() * 4 for p in model.state_dict().values())
    assert shared_prog <= baked_prog - 0.8 * param_bytes
    with np.load(os.path.join(shared_dir, "params.npz")) as flat:
        assert set(flat.files) == set(model.state_dict())
        assert all(flat[k].dtype == np.float32 for k in flat.files)
    out_s = b(pcm)
    out_b = baked(torch.from_numpy(pcm).float() * INT16_SCALE)
    assert torch.equal(out_s["clipwise_output"], out_b["clipwise_output"])
    np.testing.assert_allclose(_probs(out_s), _probs(model.forward(pcm)), atol=1e-6)


def test_dynamic_batch_bundle(bf16_model, cli_bundle):
    """One program for any batch; fixed buckets are preferred where they fit."""
    b = cli_bundle[2]
    assert b.manifest["dynamic"] is True and b.manifest["batch_sizes"] == [4]
    assert b.bucket_for(1) == 4
    assert b.bucket_for(7) == "dynamic"
    w7 = (np.random.RandomState(3).randn(7, N) * 3000).astype(np.int16)
    out = b(w7)  # B=7 > 4: the dynamic program, unpadded
    np.testing.assert_allclose(_probs(out), _probs(bf16_model.forward(w7)), atol=1e-6)
    assert BundleModel(b).max_batch is None


def test_export_cli(cli_bundle, wav):
    """The CLI end to end; each program holds one fused block op per block:
    stages 1-2 in its unfused-rounding mode, stages 3-4 in its own."""
    rc, out, b, _ = cli_bundle
    assert rc == 0
    assert b.manifest["compute_dtype"] == "bfloat16" and b.manifest["input_dtype"] == "int16"
    assert set(b.manifest["entries"]) == {"forward:4", "forward:dynamic"}
    assert calls_k1(b._programs["forward:4"]) == 4
    res = BundleModel(b).forward(wav)
    assert res["clipwise_output"].shape == (3, 527)


def test_bundle_model_serves_through_inference_service(model, shared, wav, pcm):
    """The batcher runs against loaded programs with no live model; float
    requests are quantised to the bundle's int16 wire format, so the live
    model gets the same PCM."""
    from audioset_convnext_inf_torch.engine.service import InferenceService

    b = shared[2]
    bm = BundleModel(b)
    assert bm.max_batch == 4 and bm.device == torch.device("cpu")
    ref = model.forward(pcm)
    with InferenceService(bm, batch_size=4, max_wait_ms=5.0, clip_samples=N,
                          pcm_int16=True) as svc:
        futs = [svc.submit(wav[i]) for i in range(3)]
        outs = np.stack([f.result(timeout=60)["clipwise_output"] for f in futs])
    np.testing.assert_allclose(outs, _probs(ref), atol=1e-6)
    emb = bm.forward_scene_embeddings(wav)
    np.testing.assert_allclose(emb.numpy(), model.forward_scene_embeddings(pcm).numpy(),
                               atol=1e-5)
    with pytest.raises(ValueError, match="no 'missing'"):
        b(pcm, kind="missing")


def test_bundle_int16_pcm_entry(model, bundle, shared, wav, pcm):
    b = shared[2]
    # float audio is quantised to an int16 bundle's wire grid; int16 audio
    # is decoded for an f32 bundle
    assert torch.equal(BundleModel(b)._adapt(wav), torch.from_numpy(pcm))
    assert torch.equal(BundleModel(bundle[1])._adapt(pcm),
                       torch.from_numpy(pcm).float() * INT16_SCALE)
    out = b(pcm[:2])  # B=2 pads to 4
    np.testing.assert_allclose(_probs(out), _probs(model.forward(pcm[:2])), atol=1e-6)
    with pytest.raises(ValueError, match="int16"):
        b(pcm.astype(np.float32))


def test_dynamic_export_with_fused_serving_config(bf16_model, cli_bundle):
    """The dynamic program of the bf16 serving config keeps the fused
    block op (it takes any pixel count), unlike the JAX package's, whose
    %16 gate sends a symbolic batch to the XLA trunk: so it is the port's
    live forward at every batch, bit for bit on the CPU (held to 1e-6, the
    JAX test's tolerance). Against the JAX package it is held at B=16 in
    test_bf16_programs_match_jax."""
    program = cli_bundle[2]._programs["forward:dynamic"]
    assert calls_k1(program) == 4
    rng = np.random.RandomState(1)
    for batch in (1, 2, 5):
        w = (rng.randn(batch, N) * 3000).astype(np.int16)
        out = _run(program, w)
        ref = bf16_model.forward(w)
        np.testing.assert_allclose(_probs(out), _probs(ref), atol=1e-6)
        assert torch.equal(out["clipwise_logits"], ref["clipwise_logits"])


def test_f32_program_matches_jax_export(model, bundle, wav):
    """The port's f32 bundle (B=3 in bucket 4) against the JAX package's
    exported program at B=3 on the same weights: logits 2e-4,
    probabilities 1e-5 (tests/test_torch_model.py's f32 parity
    tolerances)."""
    jm = jax_api.ConvNeXt(JaxConfig(**SIZES), jax.tree_util.tree_map(
        jnp.asarray, jax_params_from_state_dict(model.state_dict())))
    ref = jax_export_serving(jm, 3, num_samples=N).call(wav)
    out = bundle[1](wav)
    np.testing.assert_allclose(out["clipwise_logits"].numpy(),
                               np.asarray(ref["clipwise_logits"]), atol=2e-4)
    np.testing.assert_allclose(_probs(out), np.asarray(ref["clipwise_output"]), atol=1e-5)
    assert float(np.std(np.asarray(ref["clipwise_logits"]))) > 0.05  # not a near-identity trunk


def test_bf16_programs_match_jax(bf16_model, cli_bundle, monkeypatch):
    """The port's bf16 bundle at B=16 (its dynamic program) against the
    JAX package's B=16 program with its fused Pallas kernel (interpret
    mode, through the _FUSED_ON_CPU hook), int16 in: the two round bf16 at
    the same points but sum in other orders, and the logits are bf16
    values, so logits within 0.02 and probabilities within 0.005
    (tests/test_torch_model.py)."""
    monkeypatch.setattr(JF, "_FUSED_ON_CPU", True)
    params = jax_params_from_state_dict(bf16_model.state_dict())
    jm = jax_api.ConvNeXt(JaxConfig(**SIZES, block_impl="xla_approx"),
                          jax.tree_util.tree_map(jnp.asarray, params),
                          compute_dtype=jnp.bfloat16, auto_fast_serving=False)
    w = (np.random.RandomState(4).randn(16, N) * 3000).astype(np.int16)
    ref = jax_export_serving(jm, 16, pcm=True, num_samples=N).call(w)
    out = cli_bundle[2](w)
    np.testing.assert_allclose(out["clipwise_logits"].float().numpy(),
                               np.asarray(ref["clipwise_logits"]), atol=0.02)
    np.testing.assert_allclose(_probs(out), np.asarray(ref["clipwise_output"]), atol=0.005)


def test_bundle_loads_without_model_code(cli_bundle):
    """A process in which the port's models and checkpoint packages, jax
    and the JAX package cannot be imported loads the bf16 bundle (its
    programs call the fused block op) and answers bit-equal."""
    _, path, b, proc = cli_bundle
    stdout, stderr = proc.communicate(timeout=120)
    assert proc.returncode == 0, stderr[-3000:]
    loaded = eval(stdout.strip().splitlines()[-1])
    assert "audioset_convnext_inf_torch.engine.aot_export" in loaded
    assert not [m for m in loaded if m.startswith("jax")
                or m.split(".")[1] in ("models", "checkpoint")], loaded
    got = np.load(Path(path).parent / "out.npy")
    np.testing.assert_array_equal(got, _probs(b(BLOCKED_PCM)))


def test_load_refuses_another_device_and_a_missing_kernel_library(bundle, tmp_path,
                                                                  monkeypatch):
    manifest = json.loads(Path(bundle[0], "manifest.json").read_text())
    with pytest.raises(ValueError, match="exported for cpu"):
        load_bundle(bundle[0], device="meta")
    with monkeypatch.context() as mp:  # a CPU bundle serves on the CPU only when asked
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_bundle(bundle[0])
    path = tmp_path / "moved"
    path.mkdir()
    (path / "manifest.json").write_text(json.dumps(dict(manifest, device="cuda")))
    with pytest.raises(ValueError, match="exported for cuda"):
        load_bundle(str(path), device="cpu")
    (path / "manifest.json").write_text(
        json.dumps(dict(manifest, kernel_library="libfused_block_0123456789abcdef.so")))
    with pytest.raises(FileNotFoundError, match="libfused_block_0123456789abcdef"):
        load_bundle(str(path), device="cpu")
    (path / "manifest.json").write_text(json.dumps(dict(manifest, format="other")))
    with pytest.raises(ValueError, match="not an AOT"):
        load_bundle(str(path))


# ---------------------------------------------------------------------------
# K1 and K2 as custom ops
# ---------------------------------------------------------------------------

def _op_args(dtype):
    rng = np.random.RandomState(11)
    b, h, w, c = 2, 5, 4, 16

    def t(*shape, scale=0.1):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    x = t(b, h, w, c, scale=0.5).to(dtype)
    weights = [t(c, 1, 7, 7), t(c), 1 + t(c), t(c), t(4 * c, c), t(4 * c), t(c, 4 * c), t(c),
               0.5 + t(c)]
    s = torch.from_numpy(rng.uniform(0.5, 1.5, b).astype(np.float32))
    y, d = FB.fused_block_reference(x, *weights, 1e-6, s, True)
    dy = t(b, h, w, c).to(dtype)
    return {
        "fused_block": (FB._serving_op, (x, *weights, 1e-6), lambda: FB.fused_block_reference(
            x, *weights, 1e-6)),
        "fused_block_save": (FB._save_op, (x, *weights, 1e-6, s), lambda: (y, d)),
        "fused_block_bwd": (FBB._bwd_op, (x, d, dy, weights[0], *weights[2:], s, 1e-6),
                            lambda: FBB.fused_block_bwd_reference(
                                x, d, dy, weights[0], *weights[2:], s, 1e-6)),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["fused_block", "fused_block_save", "fused_block_bwd"])
def test_kernel_custom_ops_pass_opcheck_and_equal_their_plain_versions(name, dtype):
    op, args, plain = _op_args(dtype)[name]
    assert op._qualname == f"audioset_convnext_inf_torch::{name}"
    torch.library.opcheck(op, args)  # schema, fake (shape) implementation, tracing
    got, want = op(*args), plain()
    if name == "fused_block_bwd":
        want = (want[0], *(want[1][k] for k in FBB.GRAD_KEYS))
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    before = (FB.fused_block.launches, FB.fused_block.save_launches, FBB.fused_block_bwd.launches)
    op(*args)  # the CPU implementation launches nothing
    assert (FB.fused_block.launches, FB.fused_block.save_launches,
            FBB.fused_block_bwd.launches) == before
