"""The port's PANN training forward against the JAX package's: the
log-mel families (cnn, sed, cnn_next, resnet, mobilenet_v1, mobilenet_v2),
mixup, and the port's own draws. The raw-waveform families are in
``test_torch_pann_train_wave.py``.

``PannModel.forward_train`` (batch-statistic BN with its ``bn_updates``,
dropout, SpecAugment, mixup) on the weights of ``tests/torch_pann_util.py``
(the port's init, perturbed, carried across by the JAX package's converter),
against the JAX package's ``PannModel.forward_train`` on the same waveform.
The JAX function runs op by op here, so its random draws are recorded as it
makes them and handed to the port through ``draws``, one entry per key of
its KeyStream (``torch_pann_util.jax_forward_train``).

Two variants per family: (a) the config's block and head dropout at 0,
SpecAugment on (the rates written into a family's code stay), and (b) the
config's own dropout. Tolerances (``torch_pann_util.TRAIN_*``, f32 on the
CPU): probabilities within 5e-5; logits, segmentwise and framewise outputs
and embeddings within 1e-4 of their largest magnitude; every ``bn_updates``
mean and variance within 3e-5 of its largest magnitude, on the same set of
dotted paths; the module's weights and buffers bit-equal after the forward.
The MobileNets run a shortened ladder (both packages' module constants,
patched for the test): each train-mode BN over the few bins of a deep map
multiplies the summation-order differences, and 27 or 52 of them in a row
leave nothing to compare.
"""

import dataclasses

import pytest
import torch

from audioset_convnext_inf_tpu.models import pann as JP

from audioset_convnext_inf_torch.models import pann as PM
from audioset_convnext_inf_torch.models import pann_layers as P
from audioset_convnext_inf_torch.ops.mixup import mixup_pairs
from tests.torch_pann_util import compare_train, jax_forward_train, model_, waveform_


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _short_mobilenets(monkeypatch):
    """MobileNet ladders of three blocks, into the published heads' widths
    (1024 for V1; V2's 1x1 conv to 1280), in both packages."""
    v1 = [(32, 64, 1), (64, 128, 2), (128, 1024, 2)]
    v2 = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 1, 2)]
    for mod in (JP, PM):
        monkeypatch.setattr(mod, "_MBV1_LADDER", v1)
        monkeypatch.setattr(mod, "_MBV2_SETTING", v2)


N6 = (8, 8, 16, 16, 24, 32)
REG = PM.PANN_REGISTRY


def _cfg(name, **kw):
    return PM.PannConfig(name=name, **kw)


# one model per family: (config, batch, samples)
FAMILIES = {
    "cnn": (_cfg("c6", family="cnn", channels=N6), 2, 16000),
    "sed": (_cfg("st", family="sed", channels=N6, sed_head="att", fc1_out=20), 2, 16000),
    "cnn_next": (_cfg("n1", family="cnn_next",
                      next_blocks=((64, 64, 7, "avg"), (64, 64, 5, "conv"), (64, 128, 3, "no"))),
                 2, 16000),
    "resnet": (_cfg("rb", family="resnet", resnet_layers=(1, 1, 1, 1)), 4, 20480),
    "mobilenet_v1": (REG["MobileNetV1"], 4, 10240),
    "mobilenet_v2": (REG["MobileNetV2"], 4, 10240),
}


def check_family(cfg, batch, samples, variant, seed):
    """One family's forward_train against JAX's, with JAX's draws."""
    if variant.startswith("a"):
        cfg = dataclasses.replace(cfg, block_dropout=0.0, head_dropout=0.0)
    model = model_(cfg, seed=seed)
    wave = waveform_(batch, samples, seed=seed + 1)
    want, want_bn, draws = jax_forward_train(model, wave, seed)
    if variant.startswith("b"):  # the config's own dropout drew masks
        assert any(isinstance(d, torch.Tensor) for d in draws)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = model.forward_train(wave, None, draws=draws)
    probs = got["clipwise_output"].detach().numpy()
    assert ((probs > 1e-3) & (probs < 1 - 1e-3)).mean() > 0.1
    compare_train(got, want, want_bn)
    for k, v in model.state_dict().items():  # weights and buffers as they were
        assert torch.equal(v, before[k]), k


VARIANTS = ["a: dropout 0, SpecAugment on", "b: dropout on"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_train_matches_jax(family, variant):
    check_family(*FAMILIES[family], variant, seed=len(family) + len(variant))


@pytest.mark.parametrize("name", ["Cnn14", "Cnn14_mixup_time_domain"])
def test_mixup_matches_jax(name):
    """Mixup of B=4 clips into 2: on the spectrogram after bn0 and
    SpecAugment (Cnn14), on the waveform before the frontend
    (Cnn14_mixup_time_domain); the config's dropout on, narrow widths."""
    cfg = dataclasses.replace(REG[name], channels=N6)
    model = model_(cfg, seed=31)
    wave = waveform_(4, 16000, seed=32)
    lam = mixup_pairs(torch.tensor([0.3, 0.8])).numpy()
    want, want_bn, draws = jax_forward_train(model, wave, 33, mixup_lambda=lam)
    assert want["clipwise_output"].shape == (2, 527)
    got = model.forward_train(wave, None, mixup_lambda=torch.from_numpy(lam), draws=draws)
    compare_train(got, want, want_bn)


def test_own_draws_shapes_keep_rate_and_scale():
    """Without ``draws``: the masks come from the generator in the JAX
    layout, keep about 1 - rate of the elements and scale kept ones by
    1/keep; a seed gives the same forward twice; the buffers stay."""
    cfg = FAMILIES["cnn"][0]
    model = model_(cfg, seed=41)
    wave = waveform_(2, 16000, seed=42)
    seen = []
    draw = P.TrainCtx.draw

    def rec(self, make):
        d = draw(self, make)
        seen.append(d)
        return d

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(P.TrainCtx, "draw", rec)
        a = model.forward_train(wave, torch.Generator().manual_seed(7))
    finally:
        mp.undo()
    b = model.forward_train(wave, torch.Generator().manual_seed(7))
    torch.testing.assert_close(a["clipwise_logits"], b["clipwise_logits"], rtol=0, atol=0)
    (tw, tu), (fw, fu) = seen[0]  # SpecAugment first
    assert tw.shape == (2, cfg.spec_augment.time_stripes_num) and int(tw.max()) < 64
    assert fw.shape == (2, cfg.spec_augment.freq_stripes_num) and int(fw.max()) < 8
    assert float(tu.min()) >= 0.0 and float(tu.max()) < 1.0
    masks = seen[1:]
    # six block dropouts (B, T, F, C channels last), then two head dropouts (B, C)
    assert len(masks) == 8 and masks[0].shape[-1] == N6[0] and masks[-1].shape == (2, N6[-1])
    big = torch.cat([m.flatten().float() for m in masks[:2]])
    assert abs(float(big.mean()) - 0.8) < 0.02  # block dropout 0.2
    # the scale: a dropout of ones is mask / keep
    ctx = P.TrainCtx(None, draws=[masks[-1]])
    y = ctx.drop(torch.ones(2, N6[-1]), 0.5, 1)
    torch.testing.assert_close(y, masks[-1].float() / 0.5, rtol=0, atol=0)
    ctx.finish()


def test_draw_count_is_checked():
    cfg = dataclasses.replace(FAMILIES["cnn"][0], block_dropout=0.0, head_dropout=0.0,
                              use_spec_augment=False)
    model = model_(cfg, seed=51)
    wave = waveform_(2, 16000, seed=52)
    with pytest.raises(ValueError, match="more draws"):
        model.forward_train(wave, None, draws=[None] * 3)
    with pytest.raises(ValueError, match="fewer draws"):
        model.forward_train(wave, None, draws=[None] * 9)
    out = model.forward_train(wave, None, draws=[None] * 8)
    assert out["clipwise_output"].requires_grad


def test_eval_forward_is_unchanged_by_training():
    """forward stays an inference-mode eval forward with folded running
    statistics, before and after a training forward."""
    model = model_(FAMILIES["cnn"][0], seed=61)
    wave = waveform_(2, 16000, seed=62)
    first = model.forward(wave)["clipwise_output"]
    model.forward_train(wave, torch.Generator().manual_seed(0))
    second = model.forward(wave)
    torch.testing.assert_close(second["clipwise_output"], first, rtol=0, atol=0)
    assert torch.equal(second["embedding"], model.forward(wave)["embedding"])
    assert first.is_inference()
