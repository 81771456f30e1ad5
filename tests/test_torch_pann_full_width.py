"""The port's PANN families whose widths are written into the code, end to
end against the JAX package's: ResNet (basic and bottleneck, 64-512 planes
into 2048), MobileNet V1 and V2, DaiNet19, Res1dNet (planes up to 2048) and
the three wavegram models. Full width at B=1, on the shortest clip that
survives each family's pools; where the config carries the depth, one block
a stage. Method and tolerances as in test_torch_pann.py.
"""

import numpy as np
import pytest
import torch

from audioset_convnext_inf_torch.models import pann as PM
from tests.torch_pann_util import compare_, jax_forward, model_, waveform_


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, **kw):
    return PM.PannConfig(name=name, **kw)


REG = PM.PANN_REGISTRY
# name -> (config, batch, samples): 10240 samples are 33 frames, the least
# that survive a pool ladder of /32; Res1dNet pools by 5 * 4^6
CASES = {
    "dainet (DaiNet19)": (REG["DaiNet19"], 1, 4000),
    "res1dnet, one block a stage": (_cfg("r1", family="res1dnet", res1d_layers=(1,) * 7),
                                    1, 20480),
    "resnet basic, one block a stage": (_cfg("rb", family="resnet", resnet_layers=(1,) * 4),
                                        1, 10240),
    "resnet bottleneck, one block a stage": (
        _cfg("rn", family="resnet", resnet_block="bottleneck", resnet_layers=(1,) * 4),
        1, 10240),
    "mobilenet_v1 (MobileNetV1)": (REG["MobileNetV1"], 1, 10240),
    "mobilenet_v2 (MobileNetV2)": (REG["MobileNetV2"], 1, 10240),
    "wavegram (Wavegram_Cnn14)": (REG["Wavegram_Cnn14"], 1, 10240),
    "wavegram + log-mel (Wavegram_Logmel_Cnn14)": (REG["Wavegram_Logmel_Cnn14"], 1, 10240),
    "wavegram + 128-mel log-mel (Wavegram_Logmel128_Cnn14)": (
        REG["Wavegram_Logmel128_Cnn14"], 1, 10240),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_width_family_matches_jax(case):
    cfg, batch, samples = CASES[case]
    model = model_(cfg, seed=len(case))
    wave = waveform_(batch, samples, seed=len(case) + 1)
    got = model.forward(wave)
    probs = got["clipwise_output"].numpy()
    assert probs.shape == (batch, 527) and np.isfinite(probs).all()
    # the weights reach the answer: not every probability saturated
    assert ((probs > 1e-3) & (probs < 1 - 1e-3)).mean() > 0.1, case
    compare_(got, jax_forward(model, wave))
