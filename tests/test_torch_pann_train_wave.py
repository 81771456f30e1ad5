"""The port's PANN training forward against the JAX package's: the
raw-waveform families (leenet, dainet, res1dnet) and the wavegram, as
``test_torch_pann_train.py`` runs the log-mel families, with its method,
variants and tolerances."""

import pytest
import torch

from audioset_convnext_inf_torch.models import pann as PM
from tests.test_torch_pann_train import VARIANTS, check_family


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REG = PM.PANN_REGISTRY

# one model per family: (config, batch, samples); Res1dNet pools by 5 * 4^6
FAMILIES = {
    "leenet": (PM.PannConfig(name="l2", family="leenet", lee_double=True,
                             lee_channels=(8, 8, 16, 16, 16, 16, 16, 16, 24)), 2, 16000),
    "dainet": (REG["DaiNet19"], 2, 4000),
    "res1dnet": (PM.PannConfig(name="r1", family="res1dnet", res1d_layers=(1,) * 7), 4, 20480),
    "wavegram": (REG["Wavegram_Logmel_Cnn14"], 4, 20480),
}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_train_matches_jax(family, variant):
    check_family(*FAMILIES[family], variant, seed=len(family) + len(variant))
