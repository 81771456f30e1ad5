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
from audioset_convnext_inf_torch.ops import fused_block_bwd as FBB


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
    (torch.bfloat16, (16, 63, 14, 384), True),  # tiny stage-3 shape (main path)
    (torch.bfloat16, (16, 31, 7, 768), True),   # tiny stage-4 shape (main path)
    (torch.bfloat16, (3, 5, 7, 384), True),     # 105 pixels: a ragged last block
    (torch.bfloat16, (2, 7, 7, 1024), True),    # widest bf16 width class
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


def _tol(dtype, ref):
    return (1e-4 if dtype == torch.float32 else 2.0 ** -6) * max(1.0, ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (4, 13, 14, 96)),
    (torch.bfloat16, (16, 31, 7, 768)),   # tiny stage-4 shape
    (torch.bfloat16, (4, 13, 14, 100)),   # odd width
    (torch.bfloat16, (16, 63, 14, 384)),  # tiny stage-3 shape
    (torch.bfloat16, (3, 5, 7, 768)),     # 105 pixels: a ragged last block
])
def test_fused_block_save_mode_matches_plain_version(dtype, shape):
    """Save mode: y with per-sample scales (zeros among them) and d, within
    the kernel tolerance of the plain version."""
    _need_card()
    rng = np.random.RandomState(1)
    args = _block_args(rng, shape[-1])
    x = torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32)).cuda().to(dtype)
    s = torch.from_numpy(((rng.rand(shape[0]) > 0.3) / 0.7).astype(np.float32)).cuda()
    s[0] = 0.0
    before = (FB.fused_block.launches, FB.fused_block.save_launches)
    y, d = FB.fused_block(x, *args, 1e-6, s=s, save_dwconv=True)
    torch.cuda.synchronize()
    assert (FB.fused_block.launches, FB.fused_block.save_launches) == (before[0] + 1, before[1] + 1)
    y_ref, d_ref = FB.fused_block_reference(x, *args, 1e-6, s, True)
    for got, ref in ((y, y_ref), (d, d_ref)):
        assert got.dtype == dtype and (got.float() - ref.float()).abs().max().item() <= _tol(dtype, ref)


def _bwd_case(rng, shape, dtype):
    c = shape[-1]
    fwd = _block_args(rng, c)
    x = torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32)).cuda().to(dtype)
    s = torch.from_numpy(((rng.rand(shape[0]) > 0.3) / 0.7).astype(np.float32)).cuda()
    _, d = FB.fused_block_reference(x, *fwd, 1e-6, s, True)
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda().to(dtype)
    return x, d, dy, (fwd[0], *fwd[2:]), s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (4, 13, 14, 96)),
    (torch.bfloat16, (16, 31, 7, 768)),   # tiny stage-4 shape
    (torch.bfloat16, (4, 13, 14, 100)),   # odd width
    (torch.float32, (2, 7, 7, 1024)),     # widest: the most shared memory
    (torch.bfloat16, (16, 63, 14, 384)),  # tiny stage-3 shape
    (torch.bfloat16, (3, 5, 7, 384)),     # 105 pixels: a ragged last chain block
    (torch.bfloat16, (2, 7, 7, 1024)),    # widest bf16 chain (205 KB shared memory)
    (torch.bfloat16, (3, 5, 4, 1)),       # C=1: padded tiles, many split ranges
])
def test_fused_block_bwd_matches_plain_version_and_is_deterministic(dtype, shape):
    """dx and the nine gradients within the kernel tolerance of the plain
    version's; a second run gives bit-equal results (no float atomics)."""
    _need_card()
    x, d, dy, w, s = _bwd_case(np.random.RandomState(2), shape, dtype)
    before = FBB.fused_block_bwd.launches
    dx, g = FBB.fused_block_bwd(x, d, dy, *w, s)
    dx2, g2 = FBB.fused_block_bwd(x, d, dy, *w, s)
    torch.cuda.synchronize()
    assert FBB.fused_block_bwd.launches == before + 2
    dx_ref, g_ref = FBB.fused_block_bwd_reference(x, d, dy, *w, s)
    assert dx.dtype == dtype and (dx.float() - dx_ref.float()).abs().max().item() <= _tol(dtype, dx_ref)
    assert torch.equal(dx, dx2)
    for k in g_ref:
        assert (g[k] - g_ref[k]).abs().max().item() <= _tol(dtype, g_ref[k]), k
        assert torch.equal(g[k], g2[k]), k


WIDTHS = (1, 100, 160, 192, 256, 320, 384, 512, 640, 768, 1024)


@pytest.mark.cuda
def test_launch_plans_agree_with_the_kernels():
    """Each plan's shared memory is what the kernel computes for it, the
    kernels refuse a plan they cannot run, and the wrapper raises on a
    refused launch."""
    _need_card()
    k1, k2 = FB._lib(), FBB._lib()
    for c in WIDTHS:
        for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            p, q = FB.launch_plan(c, dt, 3472), FBB.launch_plan(c, dt, 3472)
            assert k1.fused_block_plan_smem(c, code, p.mt, p.cp) == p.smem_bytes, (c, dt)
            assert k2.fused_block_bwd_plan_smem(c, code, q.mt, q.cp) == q.chain_smem, (c, dt)
            assert k1.fused_block_plan_smem(c, code, 48, p.cp) == -1
            assert k2.fused_block_bwd_plan_smem(c, code, q.mt, q.cp + 8) == -1
    assert k2.fused_block_bwd_wgrad_smem() == FBB.WGRAD_SMEM
    rng = np.random.RandomState(3)
    args = _block_args(rng, 384)
    x = torch.from_numpy(rng.randn(2, 5, 5, 384).astype(np.float32)).cuda().to(torch.bfloat16)
    bad = FB.launch_plan(384, torch.bfloat16, 50)._replace(mt=32)
    with pytest.raises(RuntimeError, match="cudaError"):
        FB._forward_cuda(x, *args, 1e-6, None, False, bad)


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


@pytest.mark.cuda
def test_from_pretrained_round_trip_on_the_card(tmp_path):
    """A bf16 serving convnext_atto written as safetensors and as a native
    directory loads on the card with bit-equal outputs."""
    _need_card()
    from audioset_convnext_inf_torch.checkpoint.io import save_checkpoint, save_safetensors
    from audioset_convnext_inf_torch.models import ConvNeXt, convnext_atto

    with pytest.warns(UserWarning, match="auto-switched"):
        model = convnext_atto(compute_dtype=torch.bfloat16, seed=3)
    pcm = (np.random.RandomState(0).randn(4, 32000) * 3000).astype(np.int16)
    ref = model.forward(pcm)
    st = str(tmp_path / "m.safetensors")
    save_safetensors(model.state_dict(), st)
    native = save_checkpoint(str(tmp_path / "native"), model.state_dict(), model.cfg)
    for path in (st, native):
        loaded = ConvNeXt.from_pretrained(path, compute_dtype=torch.bfloat16, cfg=model.cfg)
        assert next(loaded.parameters()).is_cuda
        FB.fused_block.launches = 0
        got = loaded.forward(pcm)
        torch.cuda.synchronize()
        assert FB.fused_block.launches == sum(model.cfg.depths[2:])
        for k in ref:
            assert torch.equal(got[k], ref[k]), (path, k)


@pytest.mark.cuda
def test_evaluator_on_the_card_matches_forward():
    """The Evaluator's probabilities over padded int16 batches equal
    model.forward's on the same batches; K1 runs for every batch."""
    _need_card()
    from audioset_convnext_inf_torch.data import DataLoader
    from audioset_convnext_inf_torch.engine.evaluator import Evaluator
    from audioset_convnext_inf_torch.models import convnext_atto

    with pytest.warns(UserWarning, match="auto-switched"):
        model = convnext_atto(compute_dtype=torch.bfloat16, seed=4)
    rng = np.random.RandomState(1)
    pcm = (rng.randn(11, 32000) * 3000).astype(np.int16)
    target = (rng.rand(11, 527) < 0.1).astype(np.float32)

    class Memory:
        def __getitem__(self, meta):
            i = meta["i"]
            return {"waveform": pcm[i], "target": target[i]}

    batches = [[{"i": i} for i in range(s, min(s + 4, 11))] for s in range(0, 11, 4)]
    FB.fused_block.launches = 0
    out = Evaluator(model).infer_probs(DataLoader(Memory(), batches, num_workers=2,
                                                  pad_to_batch_size=4))
    torch.cuda.synchronize()
    assert FB.fused_block.launches == 3 * sum(model.cfg.depths[2:])
    np.testing.assert_array_equal(out["target"], target)
    ref = np.concatenate([
        model.forward(np.pad(pcm[s:s + 4], ((0, 4 - len(pcm[s:s + 4])), (0, 0))))
        ["clipwise_output"].cpu().numpy()[:len(pcm[s:s + 4])] for s in range(0, 11, 4)])
    np.testing.assert_array_equal(out["clipwise_output"], ref)
