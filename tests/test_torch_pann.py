"""The port's PANN zoo end to end against the JAX package's, family by family.

Each model is built by the port (``build_pann_model``) from its init,
perturbed with seeded values (every BN statistic and scale, the residual
branches' zero-init scales and the deformable offsets included), and its
state dict crosses to the JAX layout through the JAX package's converter;
the JAX side is its own ``PannModel`` (the family's apply, jitted, its own
LogMelFrontend). The same seeded waveform goes into both. Here are the
families whose config carries the widths, run narrow; those with widths
written into the code are in ``test_torch_pann_full_width.py``.

Tolerances (f32 on the CPU): probabilities, embeddings, segmentwise and
framewise outputs within 1e-4 abs, logits within 3e-4 (the JAX package's
own Cnn14 oracle bound).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioset_convnext_inf_tpu.ops.frontend import LogMelFrontend as JaxLogMelFrontend

from audioset_convnext_inf_torch.models import pann as PM
from audioset_convnext_inf_torch.ops.frontend import LogMelFrontend
from tests.torch_pann_util import close, compare_, jax_forward, jax_frontend, model_, waveform_

PannConfig = PM.PannConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cnn(name, **kw):
    return PannConfig(name=name, family=kw.pop("family", "cnn"), **kw)


N4 = (8, 16, 16, 24)  # narrow 4-block ladder (Cnn6 / Cnn10)
N6 = (8, 8, 16, 16, 24, 32)  # narrow 6-block ladder (Cnn14)

# name -> (config, batch, samples, offset_std)
CASES = {
    "cnn 4-block conv": (_cnn("c4", channels=N4), 2, 32000, 0.0),
    "cnn 6-block conv": (_cnn("c6", channels=N6), 2, 32000, 0.0),
    "cnn 4-block conv5x5": (_cnn("c5", channels=N4, block="conv5x5"), 2, 32000, 0.0),
    "cnn 6-block sep": (_cnn("cs", channels=N6, block="sep"), 2, 32000, 0.0),
    "cnn 6-block seppw": (_cnn("cp", channels=N6, block="seppw"), 2, 32000, 0.0),
    "cnn 6-block deformable 5-6": (_cnn("cd", channels=N6, deformable_blocks=(5, 6)),
                                   2, 32000, 0.3),
    "cnn 4-block conv5x5 deformable 3-4": (
        _cnn("cd5", channels=N4, block="conv5x5", deformable_blocks=(3, 4)), 2, 32000, 0.3),
    "cnn 6-block emb 12": (_cnn("ce", channels=N6, fc1_out=12), 2, 32000, 0.0),
    "sed max": (_cnn("sm", family="sed", channels=N6, sed_head="max"), 2, 32000, 0.0),
    "sed avg": (_cnn("sa", family="sed", channels=N6, sed_head="avg"), 2, 32000, 0.0),
    "sed att": (_cnn("st", family="sed", channels=N6, sed_head="att", fc1_out=20),
                2, 48000, 0.0),
    "cnn_next stem avg/conv/no": (
        _cnn("n1", family="cnn_next",
             next_blocks=((64, 64, 7, "avg"), (64, 64, 5, "conv"), (64, 128, 3, "no"))),
        2, 32000, 0.0),
    "cnn_next no stem, no fc1": (
        _cnn("n2", family="cnn_next", next_stem=False, use_fc1=False,
             next_blocks=((1, 8, 7, "avg"), (8, 16, 5, "avg"), (16, 32, 3, "no"))),
        2, 32000, 0.0),
    "cnn_next group1 conv pools": (
        _cnn("n3", family="cnn_next", next_group1=True, fc1_out=12,
             next_blocks=((64, 16, 7, "conv"), (16, 24, 7, "conv"))), 2, 32000, 0.0),
    "leenet": (_cnn("l1", family="leenet", lee_channels=(8, 8, 16, 16, 16, 16, 16, 16, 24),
                    fc1_out=12), 2, 32000, 0.0),
    "leenet double": (_cnn("l2", family="leenet", lee_double=True,
                           lee_channels=(8, 8, 16, 16, 16, 16, 16, 16, 24)), 2, 32000, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_matches_jax(case):
    cfg, batch, samples, offset_std = CASES[case]
    model = model_(cfg, seed=len(case), offset_std=offset_std)
    wave = waveform_(batch, samples, seed=len(case) + 1)
    got = model.forward(wave)
    probs = got["clipwise_output"].numpy()
    assert probs.shape == (batch, 527) and np.isfinite(probs).all()
    # the weights reach the answer: not every probability saturated
    assert ((probs > 1e-3) & (probs < 1 - 1e-3)).mean() > 0.1, case
    compare_(got, jax_forward(model, wave))


def test_deformable_offsets_are_live():
    """In the deformable case the offsets the model computes are non-zero
    and fractional, so the gather path (not a plain conv) is what matched."""
    cfg, _, _, offset_std = CASES["cnn 6-block deformable 5-6"]
    model = model_(cfg, seed=3, offset_std=offset_std)
    seen = []
    hook = model.conv_block5.conv1.offset_conv.register_forward_hook(
        lambda m, i, o: seen.append(o))
    model.forward(waveform_(1, 32000, 4))
    hook.remove()
    off = seen[0]
    assert off.abs().max() > 0.5 and (off.frac() != 0).float().mean() > 0.99


def test_the_jax_bf16_model_gives_the_f32_answer():
    """The JAX package's PannModel(compute_dtype=bf16) computes in f32 (its
    frontend casts the input to f32 and the layers cast weights to the
    activations); the port, which has only the f32 forward, matches it as
    it matches f32."""
    cfg = CASES["cnn 4-block conv"][0]
    model = model_(cfg, seed=5)
    wave = waveform_(2, 32000, 6)
    want = jax_forward(model, wave, compute_dtype=jnp.bfloat16)
    assert all(v.dtype == np.float32 for v in want.values())
    compare_(model.forward(wave), want)


@pytest.mark.parametrize("name", ["Cnn14", "Cnn14_mel32", "Cnn14_mel128", "Cnn14_16k",
                                  "Cnn14_8k"])
def test_frontend_configs_match_jax(name):
    """The five FrontendConfigs of the registry: 64, 32 and 128 mels at
    32 kHz; 16 kHz / 512 / 160 and 8 kHz / 256 / 80 at 64 mels. Within
    1e-3 dB on every bin: white noise at -20 dBFS has no near-silent bins
    (test_torch_frontend.py allows 2e-3 dB above -40 dB)."""
    cfg = PM.PANN_REGISTRY[name].frontend
    sr = cfg.sample_rate
    wave = waveform_(2, 2 * sr + 123, sr)
    got = LogMelFrontend(cfg)(torch.from_numpy(wave))
    want = np.asarray(JaxLogMelFrontend(jax_frontend(cfg))(jnp.asarray(wave)))
    assert got.shape == (2, 1, cfg.num_frames(wave.shape[1]), cfg.n_mels)
    close(got, want, 1e-3, name)


def test_sed_framewise_length_and_clipwise():
    """framewise has the log-mel's frame count; max and avg heads pool the
    segments."""
    for head in ("max", "avg"):
        cfg = dataclasses.replace(CASES["sed max"][0], sed_head=head)
        model = model_(cfg, seed=9)
        out = model.forward(waveform_(1, 32000, 10))
        assert out["framewise_output"].shape == (1, cfg.frontend.num_frames(32000), 527)
        seg = out["segmentwise_output"]
        pooled = seg.amax(dim=1) if head == "max" else seg.mean(dim=1)
        torch.testing.assert_close(out["clipwise_output"], pooled, rtol=0, atol=0)
