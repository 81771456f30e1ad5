"""The port's config copy against the JAX package's: same JSON both ways."""

import pytest

from audioset_convnext_inf_tpu import config as jax_config

from audioset_convnext_inf_torch import config as port_config

STEMS = [(252, 56), (504, 28), (504, 56), (56,), (112,)]


def _pair(**kw):
    """The same non-default config built by each package."""
    fe = dict(n_mels=128, hop_length=160, precision="high", dft_impl="direct", top_db=80.0)
    aug = dict(use_roll_augment=True, mixup_alpha=1.0)
    out = []
    for m in (jax_config, port_config):
        out.append(m.ConvNeXtConfig(
            name="custom", depths=(2, 2, 6, 2), dims=(40, 80, 160, 320),
            after_stem_dim=(504, 28), block_impl="xla_approx", **kw,
            frontend=m.FrontendConfig(**fe),
            augment=m.AugmentConfig(spec_augment=m.SpecAugmentConfig(time_drop_width=32), **aug),
        ))
    return out


@pytest.mark.parametrize("which", ["default", "custom"])
def test_config_json_round_trips_both_ways(which):
    jcfg, pcfg = ((jax_config.ConvNeXtConfig(), port_config.ConvNeXtConfig())
                  if which == "default" else _pair())
    js, ps = jax_config.config_to_json(jcfg), port_config.config_to_json(pcfg)
    assert ps == js
    assert port_config.convnext_config_from_json(js) == pcfg
    assert jax_config.convnext_config_from_json(ps) == jcfg


@pytest.mark.parametrize("stem", STEMS)
def test_stem_geometry_matches(stem):
    j = jax_config.ConvNeXtConfig(after_stem_dim=stem).stem_geometry()
    p = port_config.ConvNeXtConfig(after_stem_dim=stem).stem_geometry()
    assert p == j


def test_constants_and_frames():
    for name in ("SAMPLE_RATE", "CLIP_SECONDS", "CLIP_SAMPLES", "NUM_CLASSES", "INT16_SCALE"):
        assert getattr(port_config, name) == getattr(jax_config, name), name
    assert port_config.FrontendConfig().num_frames(port_config.CLIP_SAMPLES) == 1001
    with pytest.raises(ValueError):
        port_config.ConvNeXtConfig(after_stem_dim=(100, 10)).stem_geometry()
