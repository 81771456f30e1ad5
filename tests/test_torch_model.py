"""The port's ConvNeXt against the JAX package's, on carried weights.

The JAX package makes the parameters; they are given seeded non-trivial
values (init sets gamma = 1e-6, which would make every block nearly the
identity and let a wrong block pass), carried into the port with
``state_dict_from_jax_params`` and loaded with ``strict=True``. The same
waveforms, made with numpy, go into both.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.io import wavfile

from audioset_convnext_inf_tpu.checkpoint.convert import jax_params_to_torch_state_dict
from audioset_convnext_inf_tpu.config import ConvNeXtConfig as JaxConfig
from audioset_convnext_inf_tpu.config import config_to_json as jax_config_to_json
from audioset_convnext_inf_tpu.models import api as jax_api
from audioset_convnext_inf_tpu.models import convnext as JF

from audioset_convnext_inf_torch.checkpoint import state_dict_from_jax_params, to_tensors
from audioset_convnext_inf_torch.config import ConvNeXtConfig, convnext_config_from_json
from audioset_convnext_inf_torch.models import MODEL_REGISTRY, ConvNeXt, convnext_tiny
from audioset_convnext_inf_torch.models import convnext as MC
from audioset_convnext_inf_torch.ops import fused_block as FB

SMALL = dict(depths=(1, 1, 2, 1), dims=(32, 64, 128, 256), drop_path_rate=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    """A fresh seeded stream per test, whatever ran before in the worker."""
    return np.random.RandomState(1234)


def _randomize(params, rng):
    """Seeded values of order 0.1-1 for gamma, bn0 stats, norms and biases."""
    out = jax.tree_util.tree_map(np.asarray, params)
    n = out["bn0"]["mean"].shape[0]
    out["bn0"] = {
        "scale": rng.uniform(0.5, 2.0, n), "bias": rng.randn(n) * 0.5,
        "mean": rng.randn(n) * 5.0 - 40.0, "var": rng.uniform(50.0, 200.0, n),
    }

    def visit(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "gamma":
                    node[k] = rng.uniform(0.1, 1.0, v.shape)
                elif k == "b":
                    node[k] = rng.randn(*v.shape) * 0.05
                elif k == "scale":
                    node[k] = 1.0 + rng.randn(*v.shape) * 0.1
                elif k == "bias":
                    node[k] = rng.randn(*v.shape) * 0.05
                else:
                    visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)

    for key in ("stem", "downsample", "stages", "final_norm", "head"):
        visit(out[key])
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


def _waveforms(sample_wav_path, rng, batch, seconds=1):
    """``batch`` clips of the fixture recording (offsets, gains) plus noise."""
    _, data = wavfile.read(sample_wav_path)
    base = data.astype(np.float32) / 32767.0
    n = 32000 * seconds
    clips = []
    for i in range(batch):
        off = (i * 7919) % (base.shape[0] - n)
        clips.append(base[off:off + n] * rng.uniform(0.3, 1.0) + rng.randn(n) * 1e-3)
    return np.clip(np.stack(clips), -1.0, 1.0).astype(np.float32)


def _port_model(params, cfg, **kw):
    model = ConvNeXt(cfg, device="cpu", **kw)
    model.load_state_dict(to_tensors(state_dict_from_jax_params(params, cfg)), strict=True)
    return model


@pytest.fixture(scope="module")
def carried():
    rng = np.random.RandomState(7)
    jcfg = JaxConfig(**SMALL)
    params = _randomize(JF.init_params(jax.random.PRNGKey(0), jcfg), rng)
    return jcfg, params


def test_weight_carry_matches_jax_converter(carried):
    jcfg, params = carried
    ours = state_dict_from_jax_params(params, jcfg)
    theirs = jax_params_to_torch_state_dict(params, jcfg)
    assert list(ours) == list(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    model = _port_model(params, ConvNeXtConfig(**SMALL))
    assert set(model.state_dict()) == set(theirs)  # exactly the reference keys
    assert torch.equal(model.stages[2][1].gamma, torch.from_numpy(params["stages"][2][1]["gamma"]))


def test_f32_parity_config_matches_jax(carried, sample_wav_path, rng):
    """f32 parity config (erf GELU, frontend "highest") on 1-s clips, f32 and
    int16 input. Tolerances of the JAX package's torch-oracle parity test
    (tests/test_parity_torch.py): 2e-4 on logits and embeddings, 1e-5 on
    probabilities."""
    jcfg, params = carried
    cfg = convnext_config_from_json(jax_config_to_json(jcfg))
    jm = jax_api.ConvNeXt(jcfg, jax.tree_util.tree_map(jnp.asarray, params))
    pm = _port_model(params, cfg)
    wav = _waveforms(sample_wav_path, rng, 2)
    pcm = (wav * 32767.0).astype(np.int16)
    for x in (wav, pcm):
        ref, got = jm.forward(x), pm.forward(x)
        np.testing.assert_allclose(got["clipwise_logits"].numpy(),
                                   np.asarray(ref["clipwise_logits"]), atol=2e-4)
        np.testing.assert_allclose(got["clipwise_output"].numpy(),
                                   np.asarray(ref["clipwise_output"]), atol=1e-5)
    scene = pm.forward_scene_embeddings(wav)
    np.testing.assert_allclose(scene.numpy(), np.asarray(jm.forward_scene_embeddings(wav)),
                               atol=2e-4)
    frames = pm.forward_frame_embeddings(pcm)
    assert frames.shape == (2, 256, 3, 7)
    np.testing.assert_allclose(frames.numpy(), np.asarray(jm.forward_frame_embeddings(pcm)),
                               atol=2e-4)
    # the logits really depend on the trunk: not a near-identity network
    assert float(np.std(np.asarray(ref["clipwise_logits"]))) > 0.05


def test_bf16_serving_trunk_matches_jax_fused_path(carried, sample_wav_path, rng, monkeypatch):
    """bf16 trunk with tanh GELU, frontend "highest" (so the bf16 DFT is not
    in the comparison), B=16: the JAX side runs its fused Pallas kernel in
    interpret mode, the port its fused block's plain version (the CPU leg of
    the kernel wrapper) for every stage-3/4 block. Both round bf16 at the
    same points, but sums in another order flip single bf16 roundings, and
    the logits themselves are bf16 values (ulp 2^-7 near 1): logits within
    0.02 absolute and probabilities within 0.005 (measured 0.0078 = one
    ulp, and 0.0018)."""
    jcfg, params = carried
    jcfg = JaxConfig(**SMALL, block_impl="xla_approx")
    cfg = ConvNeXtConfig(**SMALL, block_impl="xla_approx")
    monkeypatch.setattr(JF, "_FUSED_ON_CPU", True)
    jm = jax_api.ConvNeXt(jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                          compute_dtype=jnp.bfloat16, auto_fast_serving=False)
    pm = _port_model(params, cfg, compute_dtype=torch.bfloat16, auto_fast_serving=False)

    calls = []
    plain = FB.fused_block_reference

    def counting(x, *a, **kw):
        calls.append(tuple(x.shape))
        return plain(x, *a, **kw)

    monkeypatch.setattr(FB, "fused_block_reference", counting)
    wav = _waveforms(sample_wav_path, rng, 16)
    got = pm.forward(wav)
    # one fused block per stage-3/4 block, at the stage-3 (6x14) and
    # stage-4 (3x7) grids of a 1-s clip
    assert calls == [(16, 6, 14, 128)] * 2 + [(16, 3, 7, 256)]
    ref = jm.forward(wav)
    np.testing.assert_allclose(got["clipwise_logits"].numpy(),
                               np.asarray(ref["clipwise_logits"]), atol=0.02)
    np.testing.assert_allclose(got["clipwise_output"].numpy(),
                               np.asarray(ref["clipwise_output"]), atol=0.005)


def _record_k1_serving(monkeypatch):
    """(input shape, unfused_rounding) of every call of K1's serving op."""
    calls = []
    op = FB._serving_op

    def recording(x, *a):
        calls.append((tuple(x.shape), len(a) == 11 and bool(a[10])))
        return op(x, *a)

    monkeypatch.setattr(FB, "_serving_op", recording)
    return calls


def test_bf16_serving_forward_runs_stages_1_2_through_k1_unfused_rounding(
        carried, sample_wav_path, rng, monkeypatch):
    """The bf16 serving forward calls K1's op once per block: in its
    unfused-rounding mode at stages 1-2, in its own at stages 3-4. On the
    CPU every layer's output is bit-equal to the same forward with
    ``_block_apply`` at stages 1-2 (the route before K1 took them)."""
    _, params = carried
    cfg = ConvNeXtConfig(**SMALL, block_impl="xla_approx")
    pm = _port_model(params, cfg, compute_dtype=torch.bfloat16, auto_fast_serving=False)
    wav = torch.from_numpy(_waveforms(sample_wav_path, rng, 4))

    def run():
        seen = {}
        with torch.inference_mode():
            MC.forward(pm, wav, cfg, pm.frontend, torch.bfloat16,
                       tap=lambda name, x: seen.__setitem__(name, x.clone()))
        return seen

    calls = _record_k1_serving(monkeypatch)
    got = run()
    assert calls == [((4, 27, 56, 32), True), ((4, 13, 28, 64), True),
                     ((4, 6, 14, 128), False), ((4, 6, 14, 128), False), ((4, 3, 7, 256), False)]
    routed = MC._fused_block
    monkeypatch.setattr(MC, "_fused_block", lambda x, blk, unfused_rounding=False: (
        MC._block_apply(x, blk, "xla_approx") if unfused_rounding else routed(x, blk)))
    calls.clear()
    want = run()
    assert [u for _, u in calls] == [False] * 3
    assert list(got) == list(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_training_and_f32_never_run_k1_unfused_rounding(carried, sample_wav_path, rng,
                                                         monkeypatch):
    """The route observes the model's mode and the activations' dtype: f32
    serving with tanh GELU calls K1 (its own rounding, f32) at stages 3-4
    only, and the fused bf16 training forward calls no serving op at all."""
    _, params = carried
    calls = _record_k1_serving(monkeypatch)
    wav = _waveforms(sample_wav_path, rng, 2)
    f32 = _port_model(params, ConvNeXtConfig(**SMALL, block_impl="xla_approx"))
    f32.forward(wav)
    assert [(s[-1], u) for s, u in calls] == [(128, False), (128, False), (256, False)]
    calls.clear()
    cfg = ConvNeXtConfig(**SMALL, block_impl="xla_approx", fused_train_blocks=True)
    pm = _port_model(params, cfg, compute_dtype=torch.bfloat16, auto_fast_serving=False)
    pm.train()
    out = MC.forward_train(pm, torch.from_numpy(wav), cfg, pm.frontend,
                           compute_dtype=torch.bfloat16)
    assert out["clipwise_output"].shape == (2, 527) and calls == []


def _record_training_ops(monkeypatch):
    """(op, input shape, unfused_rounding) of every call of K1's save op and
    K2's op."""
    from audioset_convnext_inf_torch.ops import fused_block_bwd as FBB

    calls = []

    def recording(name, op, n):
        def call(x, *a):
            calls.append((name, tuple(x.shape), len(a) == n and bool(a[-1])))
            return op(x, *a)
        return call

    monkeypatch.setattr(FB, "_save_op", recording("save", FB._save_op, 12))
    monkeypatch.setattr(FBB, "_bwd_op", recording("bwd", FBB._bwd_op, 13))
    return calls


@pytest.mark.parametrize("case", ["bf16", "f32", "remat", "unfused", "eval"])
def test_bf16_fused_training_runs_stages_1_2_in_the_unfused_rounding_modes(
        carried, sample_wav_path, rng, monkeypatch, case):
    """The route observes the model's mode, the config's gate and the
    activations' dtype: a bf16 fused training forward and backward calls
    K1's save op and K2's op once a block, at stages 1-2 in their
    unfused-rounding modes and at stages 3-4 in their own; f32 fused
    training calls them at stages 3-4 only, remat_blocks,
    fused_train_blocks=False and eval never. The serving op is never
    called in training."""
    _, params = carried
    kw = {"remat": dict(remat_blocks=True), "unfused": dict(fused_train_blocks=False)}.get(
        case, {})
    cfg = ConvNeXtConfig(**{**SMALL, "drop_path_rate": 0.2}, block_impl="xla_approx",
                         **{"fused_train_blocks": True, **kw})
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    pm = _port_model(params, cfg, compute_dtype=dtype, auto_fast_serving=False)
    wav = torch.from_numpy(_waveforms(sample_wav_path, rng, 4))
    calls = _record_training_ops(monkeypatch)
    serving = _record_k1_serving(monkeypatch)
    if case == "eval":
        MC.forward(pm, wav, cfg, pm.frontend, dtype)
        assert calls == [] and [u for _, u in serving] == [True, True, False, False, False]
        return
    pm.train()
    out = MC.forward_train(pm, wav, cfg, pm.frontend, torch.Generator().manual_seed(3),
                           compute_dtype=dtype)
    out["clipwise_logits"].float().sum().backward()
    assert serving == []
    stages34 = [((4, 6, 14, 128), False), ((4, 6, 14, 128), False), ((4, 3, 7, 256), False)]
    want = {"bf16": [((4, 27, 56, 32), True), ((4, 13, 28, 64), True)] + stages34,
            "f32": stages34}.get(case, [])
    assert [(s, u) for op, s, u in calls if op == "save"] == want
    # the backward runs the blocks in reverse
    assert [(s, u) for op, s, u in calls if op == "bwd"] == want[::-1]
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in pm.parameters() if p.requires_grad)


def test_bf16_auto_switch_warns_like_jax(carried):
    jcfg, params = carried
    cfg = ConvNeXtConfig(**SMALL)
    with pytest.warns(UserWarning) as jrec:
        jax_api.ConvNeXt(jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                         compute_dtype=jnp.bfloat16)
    with pytest.warns(UserWarning, match="'xla' -> 'xla_approx'") as rec:
        m = ConvNeXt(cfg, compute_dtype=torch.bfloat16, device="cpu")
    assert [str(w.message) for w in rec] == [str(w.message) for w in jrec]
    assert m.cfg.block_impl == "xla_approx" and m.cfg.frontend.precision == "default"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m2 = ConvNeXt(cfg, compute_dtype=torch.bfloat16, auto_fast_serving=False, device="cpu")
        m3 = ConvNeXt(cfg, device="cpu")
    assert not [w for w in caught if "auto-switched" in str(w.message)]
    assert m2.cfg.block_impl == "xla" and m2.cfg.frontend.precision == "highest"
    assert m3.cfg.block_impl == "xla" and m3.cfg.frontend.precision == "highest"


def test_tiny_parameter_count():
    assert convnext_tiny(device="cpu").count_parameters() == 28_222_767


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_factories_shapes_and_counts(name):
    """Every factory builds on the CPU with the JAX package's parameter count
    and gives the reference output shapes (checked on a 1-s clip)."""
    model = MODEL_REGISTRY[name](device="cpu")
    jcfg = JaxConfig(depths=model.cfg.depths, dims=model.cfg.dims)
    shapes = jax.eval_shape(lambda k: JF.init_params(k, jcfg), jax.random.PRNGKey(0))
    assert model.count_parameters() == JF.count_parameters(shapes)
    wav = np.zeros((1, 32000), np.float32)
    c = model.cfg.dims[-1]
    out = model.forward(wav)
    assert out["clipwise_output"].shape == (1, 527)
    assert model.forward_scene_embeddings(wav).shape == (1, c)
    assert model.forward_frame_embeddings(wav).shape == (1, c, 3, 7)
