"""The port's checkpoint I/O against the JAX package's.

The JAX package makes seeded parameters and writes them in each format it
knows (safetensors, native directories with optax optimizer state, .pth);
the port reads them, and the JAX package reads what the port writes. The
same numpy inputs go through both models where outputs are compared.
"""

import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import load_file, save_file

import jax
import jax.numpy as jnp

from audioset_convnext_inf_tpu.checkpoint import convert as JC
from audioset_convnext_inf_tpu.checkpoint import io as JIO
from audioset_convnext_inf_tpu.cli import convert as jax_convert_cli
from audioset_convnext_inf_tpu.config import ConvNeXtConfig as JaxConfig
from audioset_convnext_inf_tpu.config import config_to_json as jax_config_to_json
from audioset_convnext_inf_tpu.models import api as jax_api
from audioset_convnext_inf_tpu.ops.frontend import mel_filterbank as jax_mel_filterbank

from audioset_convnext_inf_torch.checkpoint import convert as C
from audioset_convnext_inf_torch.checkpoint import io as IO
from audioset_convnext_inf_torch.cli import convert as convert_cli
from audioset_convnext_inf_torch.config import ConvNeXtConfig, config_to_json
from audioset_convnext_inf_torch.models import ConvNeXt, convnext_atto

from tests.test_torch_model import SMALL, _randomize, _waveforms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried():
    rng = np.random.RandomState(11)
    jcfg = JaxConfig(**SMALL)
    params = _randomize(_port_init(ConvNeXtConfig(**SMALL), 0), rng)
    return jcfg, ConvNeXtConfig(**SMALL), params


def _port_init(cfg, seed):
    """Fresh parameters in the JAX package's layout, drawn by the port's
    init (the JAX package's op-by-op init takes seconds per model here)."""
    return C.jax_params_from_state_dict(ConvNeXt(cfg, device="cpu", seed=seed).state_dict())


def _reference_sd(params, jcfg):
    return JC.jax_params_to_torch_state_dict(params, jcfg)


def _assert_same_sd(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                      np.asarray(want[k], np.float32), err_msg=k)


@pytest.mark.parametrize("writer", ["port", "library"])
@pytest.mark.parametrize("metadata", [None, {}, {"format": "pt"}])
def test_safetensors_reader_and_writer_match_the_library(tmp_path, writer, metadata):
    """f32, f16 and i64 tensors (and an empty or absent ``__metadata__``)
    survive either writer and either reader bit for bit."""
    rng = np.random.RandomState(0)
    tensors = {
        "w.f32": rng.randn(3, 5).astype(np.float32),
        "b.f16": rng.randn(7).astype(np.float16),
        "idx.i64": rng.randint(-2**40, 2**40, size=(2, 2, 2)).astype(np.int64),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.array(3.5, np.float32),
    }
    path = str(tmp_path / "t.safetensors")
    if writer == "port":
        IO.save_safetensors(tensors, path, metadata=metadata)
        with open(path, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
        assert (8 + n) % 8 == 0
        got = load_file(path)
        with safe_open(path, "np") as f:
            assert (f.metadata() or {}) == (metadata or {})
    else:
        save_file(tensors, path, metadata=metadata)
        got = IO.read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_safetensors_reader_rejects_what_it_cannot_hold(tmp_path):
    """Data cut short, and a dtype numpy has no type for (bf16)."""
    path = str(tmp_path / "b.safetensors")
    from safetensors.torch import save_file as save_torch

    save_file({"x": np.arange(12, dtype=np.float32)}, path)
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[:-2])
    with pytest.raises(ValueError, match="offsets"):
        IO.read_safetensors(path)
    save_torch({"x": torch.zeros(3, dtype=torch.bfloat16)}, path)
    with pytest.raises(ValueError, match="unsupported dtype 'BF16'"):
        IO.read_safetensors(path)


def test_from_pretrained_on_a_jax_written_safetensors(carried, tmp_path, sample_wav_path):
    """JAX ``save_safetensors`` -> port ``from_pretrained``: logits within
    2e-4 and probabilities within 1e-5 of the JAX model on the same weights
    (the port's f32 parity tolerances, tests/test_torch_model.py)."""
    jcfg, cfg, params = carried
    path = str(tmp_path / "m.safetensors")
    JIO.save_safetensors(params, jcfg, path)
    model = ConvNeXt.from_pretrained(path, cfg=cfg, device="cpu")
    assert model.device == torch.device("cpu")
    jm = jax_api.ConvNeXt.from_pretrained(path, cfg=jcfg)
    wav = _waveforms(sample_wav_path, np.random.RandomState(3), 2)
    got, ref = model.forward(wav), jm.forward(wav)
    np.testing.assert_allclose(got["clipwise_logits"].numpy(), np.asarray(ref["clipwise_logits"]),
                               atol=2e-4)
    np.testing.assert_allclose(got["clipwise_output"].numpy(), np.asarray(ref["clipwise_output"]),
                               atol=1e-5)
    assert float(np.std(np.asarray(ref["clipwise_logits"]))) > 0.05


@pytest.mark.parametrize("wrapped", [False, True])
def test_pth_bare_and_wrapped(carried, tmp_path, wrapped):
    """A .pth state dict, bare or as {"model": ...}, with the reference's
    extra entries (num_batches_tracked, STFT buffers, a matching melW)."""
    jcfg, cfg, params = carried
    sd = C.to_tensors(_reference_sd(params, jcfg))
    extra = dict(sd)
    extra["bn0.num_batches_tracked"] = torch.tensor(5)
    extra["spectrogram_extractor.stft.conv_real.weight"] = torch.zeros(513, 1, 1024)
    f = cfg.frontend
    extra["logmel_extractor.melW"] = torch.from_numpy(
        jax_mel_filterbank(f.sample_rate, f.n_fft, f.n_mels, f.fmin, f.fmax).T.copy())
    path = str(tmp_path / "m.pth")
    torch.save({"model": extra} if wrapped else extra, path)
    got = IO.load_pretrained(path, cfg)
    _assert_same_sd(got, {k: v.numpy() for k, v in sd.items()})
    want = JIO.load_pretrained(path, jcfg)
    _assert_same_sd(got, _reference_sd(jax.tree_util.tree_map(np.asarray, want), jcfg))


@pytest.mark.parametrize("fault,error", [
    ("melW values", ValueError),
    ("melW shape", ValueError),
    ("missing key", KeyError),
    ("leftover key", ValueError),
    ("shape", ValueError),
])
def test_bad_state_dicts_raise_like_jax(carried, fault, error):
    jcfg, cfg, params = carried
    sd = dict(_reference_sd(params, jcfg))
    f = cfg.frontend
    mel = jax_mel_filterbank(f.sample_rate, f.n_fft, f.n_mels, f.fmin, f.fmax).T
    if fault == "melW values":
        sd["logmel_extractor.melW"] = mel * 1.01
    elif fault == "melW shape":
        sd["logmel_extractor.melW"] = mel[:, :-1]
    elif fault == "missing key":
        del sd["stages.2.1.pwconv1.bias"]
    elif fault == "leftover key":
        sd["stages.2.2.norm.weight"] = np.ones(128, np.float32)
    else:
        sd["head_audioset.weight"] = np.zeros((527, 255), np.float32)
    with pytest.raises(error):
        C.load_reference_state_dict(sd, cfg)
    with pytest.raises(error):
        JC.torch_state_dict_to_params(sd, jcfg)
    if fault == "leftover key":  # non-strict drops it
        assert "stages.2.2.norm.weight" not in C.load_reference_state_dict(sd, cfg, strict=False)


def test_missing_gamma_loads_as_no_layer_scale(carried, sample_wav_path):
    """A checkpoint without gamma: the JAX model skips the layer scale, the
    port multiplies by ones; the outputs agree (f32 parity tolerance)."""
    jcfg, cfg, params = carried
    sd = {k: v for k, v in _reference_sd(params, jcfg).items() if not k.endswith(".gamma")}
    got = C.load_reference_state_dict(sd, cfg)
    np.testing.assert_array_equal(got["stages.0.0.gamma"], np.ones(32, np.float32))
    model = ConvNeXt(cfg, device="cpu")
    model.load_state_dict(C.to_tensors(got), strict=True)
    jm = jax_api.ConvNeXt(jcfg, JC.torch_state_dict_to_params(sd, jcfg))
    wav = _waveforms(sample_wav_path, np.random.RandomState(4), 1)
    np.testing.assert_allclose(model.forward(wav)["clipwise_logits"].numpy(),
                               np.asarray(jm.forward(wav)["clipwise_logits"]), atol=2e-4)


_READ_BLOCKED = r"""
import sys, json
import numpy as np
for name in ("jax", "jaxlib", "optax", "audioset_convnext_inf_tpu"):
    sys.modules[name] = None
from audioset_convnext_inf_torch.checkpoint import load_checkpoint, state_dict_from_jax_params
from audioset_convnext_inf_torch.config import ConvNeXtConfig
from audioset_convnext_inf_torch.models import ConvNeXt
state = load_checkpoint(sys.argv[1])
cfg = state["config"]
model = ConvNeXt.from_pretrained(sys.argv[1], cfg=cfg, device="cpu")
np.savez(sys.argv[2], **{k: v.numpy() for k, v in model.state_dict().items()})
adam = state["opt_state"][0]
print(json.dumps({"iteration": state["iteration"], "dims": list(cfg.dims),
                  "opt_class": type(adam)._pickled_as, "count": int(adam[0]),
                  "sampler": state["sampler_state"]["epoch"]}))
"""


def test_port_reads_a_jax_native_checkpoint_with_optax_state(carried, tmp_path):
    """A JAX ``save_checkpoint`` directory holding a real ``optax.adamw``
    state, read by the port in a process where jax, optax and the JAX
    package cannot be imported."""
    jcfg, _, params = carried
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = optax.adamw(1e-3).init(jparams)
    ck = str(tmp_path / "jax_ck")
    JIO.save_checkpoint(ck, jparams, jcfg, opt_state=opt_state, iteration=7,
                        sampler_state={"epoch": 2, "perm": np.arange(4)})
    out = str(tmp_path / "sd.npz")
    proc = subprocess.run([sys.executable, "-c", _READ_BLOCKED, ck, out], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info == {"iteration": 7, "dims": list(jcfg.dims),
                    "opt_class": "optax._src.transform.ScaleByAdamState", "count": 0,
                    "sampler": 2}
    with np.load(out) as z:
        _assert_same_sd(dict(z), _reference_sd(params, jcfg))


class _Calls:
    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("fn,args", [(os.system, ("exit 3",)), (np.load, ("x.npy",)),
                                     (eval, ("1 + 1",))])
def test_native_checkpoint_pickles_run_no_code(tmp_path, fn, args):
    """A state.pkl naming a function: functions of other modules unpickle as
    inert stand-ins, builtins outside the plain types are refused."""
    import pickle

    with open(tmp_path / "state.pkl", "wb") as f:
        pickle.dump({"params": _Calls(fn, *args)}, f)
    if fn is eval:
        with pytest.raises(pickle.UnpicklingError, match="builtins.eval"):
            IO.load_checkpoint(str(tmp_path))
        return
    got = IO.load_checkpoint(str(tmp_path))["params"]
    assert isinstance(got, IO._Inert) and tuple(got) == args


def test_jax_reads_a_port_native_checkpoint(carried, tmp_path):
    jcfg, cfg, params = carried
    model = ConvNeXt(cfg, device="cpu")
    model.load_state_dict(C.to_tensors(_reference_sd(params, jcfg)), strict=True)
    ck = str(tmp_path / "port_ck")
    IO.save_checkpoint(ck, model.state_dict(), cfg, iteration=3, extra={"note": "x"})
    state = JIO.load_checkpoint(ck)
    assert state["iteration"] == 3 and state["extra"] == {"note": "x"}
    assert jax_config_to_json(state["config"]) == config_to_json(cfg)
    got = jax.tree_util.tree_map(np.asarray, state["params"])
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # and the port reads its own directory back
    again = ConvNeXt.from_pretrained(ck, cfg=cfg, device="cpu")
    _assert_same_sd({k: v.numpy() for k, v in again.state_dict().items()},
                    _reference_sd(params, jcfg))


def _imagenet_sd(cfg, rng):
    """A synthetic image ConvNeXt state dict: 3-channel 4x4 stem, the
    backbone at ``cfg``'s widths, a 1000-class head, no bn0."""
    sd = {k: rng.randn(*shape).astype(np.float32) for k, shape in C.reference_shapes(cfg)
          if not k.startswith(("bn0.", "head_audioset."))}
    sd["downsample_layers.0.0.weight"] = rng.randn(cfg.dims[0], 3, 4, 4).astype(np.float32)
    sd["head.weight"] = rng.randn(1000, cfg.dims[-1]).astype(np.float32)
    sd["head.bias"] = rng.randn(1000).astype(np.float32)
    sd["stages.3.0.pwconv1.weight"] = rng.randn(7, 7).astype(np.float32)  # shape mismatch: skipped
    return sd


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_imagenet_backbone_matches_jax(carried, wrapped):
    jcfg, cfg, params = carried
    img = _imagenet_sd(cfg, np.random.RandomState(5))
    blob = {"model": img} if wrapped else img
    init = _reference_sd(params, jcfg)
    got = C.load_imagenet_backbone(blob, cfg, init)
    want = _reference_sd(jax.tree_util.tree_map(np.asarray, JC.load_imagenet_backbone(
        blob, jcfg, jax.tree_util.tree_map(jnp.asarray, params))), jcfg)
    _assert_same_sd(got, want)
    np.testing.assert_array_equal(got["stages.1.0.dwconv.weight"], img["stages.1.0.dwconv.weight"])
    for k in ("downsample_layers.0.0.weight", "bn0.weight", "head_audioset.weight",
              "stages.3.0.pwconv1.weight"):
        np.testing.assert_array_equal(got[k], init[k])


def test_factory_pretrained_imagenet(tmp_path):
    """``convnext_atto(pretrained_imagenet=...)`` takes the backbone of a
    local image-ConvNeXt .pth and keeps its own stem and head."""
    fresh = convnext_atto(device="cpu")
    img = _imagenet_sd(fresh.cfg, np.random.RandomState(6))
    path = str(tmp_path / "img.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in img.items()}}, path)
    model = convnext_atto(pretrained_imagenet=path, device="cpu")
    sd, before = model.state_dict(), fresh.state_dict()
    key = "stages.2.5.pwconv2.weight"
    assert torch.equal(sd[key], torch.from_numpy(img[key]))
    for key in ("downsample_layers.0.0.weight", "head_audioset.weight"):
        assert torch.equal(sd[key], before[key])


def test_cli_convert_both_ways(tmp_path):
    """A JAX-written convnext_atto safetensors -> port CLI -> native
    directory (read by the JAX package, with its config) -> port CLI ->
    safetensors, equal to the input and to the JAX CLI's conversion."""
    jcfg = JaxConfig(name="convnext_atto", depths=(2, 2, 6, 2), dims=(40, 80, 160, 320))
    params = _port_init(ConvNeXtConfig(name="convnext_atto", depths=jcfg.depths, dims=jcfg.dims), 1)
    src = str(tmp_path / "in.safetensors")
    JIO.save_safetensors(params, jcfg, src)
    native = str(tmp_path / "native")
    assert convert_cli.main([src, native, "--to", "native", "--model", "convnext_atto",
                             "--device", "cpu"]) == 0
    state = JIO.load_checkpoint(native)
    assert state["config"].name == "convnext_atto" and state["config"].dims == jcfg.dims
    for a, b in zip(jax.tree_util.tree_leaves(state["params"]), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = str(tmp_path / "back.safetensors")
    assert convert_cli.main([native, back, "--device", "cpu"]) == 0  # config from the directory
    jax_back = str(tmp_path / "jax_back.safetensors")
    assert jax_convert_cli.main([native, jax_back]) == 0
    _assert_same_sd(IO.read_safetensors(back), load_file(src))
    _assert_same_sd(IO.read_safetensors(back), load_file(jax_back))


@pytest.mark.parametrize("path", ["missing/ckpt.pth", "./nowhere.safetensors", "/abs/nowhere",
                                  "nowhere.pth", "a/b/c"])
def test_a_missing_local_path_fails_fast(path):
    """Neither a download nor a hub lookup for what is plainly a path."""
    with pytest.raises(FileNotFoundError):
        IO._resolve_checkpoint_path(path)
    with pytest.raises(FileNotFoundError):
        JIO._resolve_checkpoint_path(path)


# ---------------------------------------------------------------------------
# The port's optimizer state in optax's layout: the JAX trainer resumes it
# ---------------------------------------------------------------------------

TINY = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), drop_path_rate=0.0)
LAYOUTS = {
    "optax.adamw": dict(),
    "optax.adam": dict(optimizer="adam"),
    "optax.inject_hyperparams(adamw)": dict(use_wd_schedule=True, wd_constant_cooldown=False),
    "optax.MultiSteps(optax.adamw)": dict(accumulation_steps=2),
    "optax.MultiSteps(optax.adam)": dict(optimizer="adam", accumulation_steps=2),
    "optax.MultiSteps(optax.inject_hyperparams(adamw))": dict(accumulation_steps=2,
                                                              use_wd_schedule=True),
}


def test_optax_stand_ins_have_the_installed_optax_fields():
    """Each stand-in class the port pickles has the fields, in order, of the
    class its top-level name gives in the installed optax, and
    inject_hyperparams builds the stand-in's class."""
    for cls in (IO._ScaleByAdamState, IO._ScaleByScheduleState, IO._MaskedState,
                IO._EmptyState, IO._MultiStepsState, IO._InjectState):
        assert cls._optax_module == "optax"
        assert getattr(optax, cls.__name__)._fields == cls._fields, cls.__name__
    from optax.schedules import _inject

    assert _inject.WrappedScheduleState._fields == IO._WrappedScheduleState._fields
    params = {"w": jnp.ones((2, 2))}
    state = optax.inject_hyperparams(optax.adamw)(learning_rate=lambda c: 0.1).init(params)
    assert type(state).__name__ == IO._InjectState.__name__


def _trained_port(kw, steps=3):
    """A port trainer (f32, no augmentation) after ``steps`` steps of one
    seeded batch of half-second clips, and that batch."""
    from audioset_convnext_inf_torch.config import AugmentConfig
    from audioset_convnext_inf_torch.engine import trainer as T

    cfg = ConvNeXtConfig(**TINY, augment=AugmentConfig(use_spec_augment=False))
    model = ConvNeXt(cfg, device="cpu", seed=2)
    tr = T.Trainer(model, T.TrainConfig(max_lr=1e-2, total_steps=10, weight_decay=0.1, **kw))
    rng = np.random.RandomState(6)
    wav = (rng.randn(4, 16000) * 0.1).astype(np.float32)
    target = (rng.rand(4, 527) < 0.05).astype(np.float32)
    for _ in range(steps):
        tr.step(wav, target)
    return tr, cfg, wav, target


@pytest.mark.parametrize("structure", sorted(LAYOUTS))
def test_jax_trainer_resumes_a_port_checkpoint_and_steps_like_the_port(tmp_path, structure):
    """The port trains 3 steps and checkpoints; the JAX package loads the
    checkpoint, its Trainer restores it (the optimizer state arrives as
    optax's own classes) and takes one step; the port takes the same step.
    The parameters agree within 1e-6, bn0's statistics within 1e-5 of scale."""
    from audioset_convnext_inf_tpu.config import AugmentConfig as JaxAugmentConfig
    from audioset_convnext_inf_tpu.engine import trainer as JT
    from audioset_convnext_inf_tpu.parallel.mesh import get_mesh

    kw = LAYOUTS[structure]
    tr, cfg, wav, target = _trained_port(kw)
    ck = str(tmp_path / "ck")
    IO.save_checkpoint(ck, tr.model.state_dict(), cfg, opt_state=tr.optimizer.state_dict(),
                       iteration=3)
    state = JIO.load_checkpoint(ck)
    jcfg = JaxConfig(**TINY, augment=JaxAugmentConfig(use_spec_augment=False))
    jtcfg = JT.TrainConfig(max_lr=1e-2, total_steps=10, weight_decay=0.1, **kw)
    jtr = JT.Trainer(jcfg, jtcfg, state["params"], mesh=get_mesh(jax.devices()[:1]))
    assert jax.tree_util.tree_structure(state["opt_state"]) == \
        jax.tree_util.tree_structure(jtr.state.opt_state)
    jtr.restore(state["params"], state["opt_state"], state["iteration"])
    jtr.step(wav, target)
    tr.step(wav, target)
    want = C.state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jtr.state.params))
    got = {k: v.numpy() for k, v in tr.model.state_dict().items()}
    for k in want:
        atol = 1e-5 * max(1.0, float(np.abs(want[k]).max())) if k.startswith("bn0.running") \
            else 1e-6
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("structure", sorted(LAYOUTS))
def test_optimizer_state_round_trips_port_jax_port_bit_equal(tmp_path, structure):
    """The port's optimizer state, written by the port, read and written
    again by the JAX package, read by the port: every field bit-equal."""
    tr, cfg, _, _ = _trained_port(LAYOUTS[structure], steps=2)
    mine = tr.optimizer.state_dict()
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    IO.save_checkpoint(a, tr.model.state_dict(), cfg, opt_state=mine, iteration=2)
    state = JIO.load_checkpoint(a)
    JIO.save_checkpoint(b, state["params"], state["config"], opt_state=state["opt_state"],
                        iteration=2)
    back = IO.optimizer_state_from_optax(IO.load_checkpoint(b)["opt_state"])
    assert back["structure"] == mine["structure"] == structure
    assert (back["count"], back["mini_step"]) == (mine["count"], mine["mini_step"])
    assert (back["hyperparams"] is None) == (mine["hyperparams"] is None)
    for k, v in (mine["hyperparams"] or {}).items():
        assert back["hyperparams"][k].tobytes() == v.tobytes(), k
    for part in ("mu", "nu", "acc"):
        if mine[part] is None:
            assert back[part] is None
            continue
        assert sorted(back[part]) == sorted(mine[part])
        for k, v in mine[part].items():
            np.testing.assert_array_equal(back[part][k], v.numpy(), err_msg=f"{part} {k}")
