"""Card-only tests of the port: each CUDA kernel against its plain version,
and the entry points' default device. They skip without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from audioset_convnext_inf_torch.ops import fused_block as FB


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")


def _block_args(rng, c, with_gamma=True):
    t = lambda *shape, s=1.0, m=0.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*shape) * s + m).astype(np.float32)).cuda()
    return [t(c, 1, 7, 7, s=0.05), t(c, s=0.05), t(c, s=0.1, m=1.0), t(c, s=0.05),
            t(4 * c, c, s=c ** -0.5), t(4 * c, s=0.05), t(c, 4 * c, s=0.5 * (4 * c) ** -0.5),
            t(c, s=0.05), t(c, s=0.3, m=0.5) if with_gamma else None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,with_gamma", [
    (torch.float32, (4, 13, 14, 96), True),
    (torch.bfloat16, (4, 13, 14, 100), True),   # odd width: ragged channel tiles
    (torch.bfloat16, (16, 31, 7, 768), False),  # tiny stage-4 shape, no gamma
    (torch.float32, (2, 7, 7, 1024), True),     # widest: dynamic shared memory
    (torch.bfloat16, (3, 5, 4, 1), True),       # C=1
])
def test_fused_block_kernel_matches_plain_version(dtype, shape, with_gamma):
    """Tolerance as in chip_smoke.py: 1e-4 (f32) or 2^-6 (bf16, four ulps)
    of the output scale."""
    _need_card()
    rng = np.random.RandomState(0)
    args = _block_args(rng, shape[-1], with_gamma)
    x = torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32)).cuda().to(dtype)
    before = FB.fused_block.launches
    got = FB.fused_block(x, *args)
    torch.cuda.synchronize()
    assert FB.fused_block.launches == before + 1
    ref = FB.fused_block_reference(x, *args)
    tol = (1e-4 if dtype == torch.float32 else 2.0 ** -6) * max(1.0, ref.float().abs().max().item())
    assert got.dtype == dtype and got.shape == x.shape
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_entry_points_default_to_the_card():
    _need_card()
    from audioset_convnext_inf_torch.models import convnext_atto

    with pytest.warns(UserWarning, match="auto-switched"):
        model = convnext_atto(compute_dtype=torch.bfloat16)
    assert next(model.parameters()).is_cuda
    FB.fused_block.launches = 0
    out = model.forward(np.zeros((2, 32000), np.int16))
    torch.cuda.synchronize()
    assert out["clipwise_output"].is_cuda and out["clipwise_output"].shape == (2, 527)
    assert FB.fused_block.launches == sum(model.cfg.depths[2:])
