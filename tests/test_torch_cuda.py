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


def _unfused_case(shape, seed):
    """bf16 x and block weights at a stage-1/2 width, with gamma in [0.1, 1]
    (the benchmark's draw), and a port Block holding the same weights."""
    from audioset_convnext_inf_torch.models.convnext import Block

    rng = np.random.RandomState(seed)
    c = shape[-1]
    args = _block_args(rng, c)
    args[-1] = torch.from_numpy(rng.uniform(0.1, 1.0, c).astype(np.float32)).cuda()
    blk = Block(c, 1e-6, 1.0).cuda()
    dst = (blk.dwconv.weight, blk.dwconv.bias, blk.norm.weight, blk.norm.bias,
           blk.pwconv1.weight, blk.pwconv1.bias, blk.pwconv2.weight, blk.pwconv2.bias, blk.gamma)
    with torch.no_grad():
        for t, d in zip(args, dst):
            d.copy_(t)
    x = torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32)).cuda().to(torch.bfloat16)
    return x, args, blk


UNFUSED_SHAPES = [
    (4, 252, 56, 96),   # stage 1 of a 10-s clip
    (4, 126, 28, 192),  # stage 2
    (3, 13, 11, 96),    # ragged: H, W and the last tile; three hidden ranges
    (1, 126, 28, 192),  # one clip at stage 2: two hidden ranges and the sum kernel
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", UNFUSED_SHAPES)
def test_unfused_rounding_mode_matches_the_unfused_block_on_the_card(shape):
    """K1's unfused-rounding mode against ``_block_apply`` (ATen's ops on
    the card, tanh GELU) on the same bf16 input: within the kernel
    tolerance, 2^-6 of the output scale (sums in another order flip single
    bf16 roundings), on x in the stem's channels-first layout too."""
    _need_card()
    from audioset_convnext_inf_torch.models.convnext import _block_apply

    x, args, blk = _unfused_case(shape, 7)
    plan = FB.launch_plan(shape[-1], torch.bfloat16, shape[0] * shape[1] * shape[2])
    # hidden ranges where the tiles alone fill under half the SMs
    assert plan.hidden_split == {(1, 126, 28, 192): 2, (3, 13, 11, 96): 3}.get(shape, 1)
    before = (FB.fused_block.launches, FB.fused_block.unfused_rounding_launches)
    with torch.no_grad():
        got = FB.fused_block(x, *args, 1e-6, unfused_rounding=True)
        nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        got_nchw = FB.fused_block(nchw, *args, 1e-6, unfused_rounding=True)
        ref = _block_apply(x, blk, "xla_approx")
    torch.cuda.synchronize()
    assert (FB.fused_block.launches, FB.fused_block.unfused_rounding_launches) == (
        before[0] + 2, before[1] + 2)
    assert got.dtype == torch.bfloat16 and got.is_contiguous() and torch.equal(got, got_nchw)
    assert (got.float() - ref.float()).abs().max().item() <= _tol(torch.bfloat16, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", UNFUSED_SHAPES)
def test_unfused_rounding_mode_is_nearer_the_unfused_block_than_k1s_own(shape):
    """On the same data the unfused-rounding mode's mean absolute gap to
    ``_block_apply`` is smaller than K1's own rounding's: the mode really
    rounds where the unfused block does. ``-s`` prints both gaps."""
    _need_card()
    from audioset_convnext_inf_torch.models.convnext import _block_apply

    x, args, blk = _unfused_case(shape, 8)
    with torch.no_grad():
        ref = _block_apply(x, blk, "xla_approx").float()
        unf = FB.fused_block(x, *args, 1e-6, unfused_rounding=True).float()
        own = FB.fused_block(x, *args, 1e-6).float()
    gaps = {k: ((v - ref).abs().mean().item(), (v - ref).abs().max().item(),
                (v == ref).float().mean().item()) for k, v in (("unfused", unf), ("own", own))}
    print(f"\nK1 vs _block_apply at {shape}: mean / max abs gap, share bit-equal: "
          + "; ".join(f"{k} {m:.3e} / {mx:.3e}, {eq:.4f}" for k, (m, mx, eq) in gaps.items()))
    assert gaps["unfused"][0] < gaps["own"][0]


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
    (torch.bfloat16, (2, 7, 7, 1024)),    # widest bf16 chain: four dxn reduction ranges
    (torch.bfloat16, (3, 5, 4, 1)),       # C=1: padded tiles, many split ranges
    (torch.bfloat16, (1, 9, 11, 200)),    # B=1, odd H and W, C not a multiple of 128
    (torch.float32, (1, 9, 11, 200)),
    (torch.bfloat16, (2, 37, 45, 96)),    # stencil tiles in both directions, ragged
    (torch.float32, (2, 37, 45, 96)),
    (torch.bfloat16, (1, 33, 7, 72)),     # C % 8 == 0 under one 64-channel slab
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


TRAIN_UNFUSED_SHAPES = [
    (4, 252, 56, 96),   # stage 1 of a 10-s clip (convnext_tiny)
    (4, 126, 28, 192),  # stage 2
    (3, 13, 11, 96),    # ragged: H, W and the last tile; three hidden ranges
    (1, 126, 28, 192),  # B = 1: two hidden ranges and K1's sum kernel
    (2, 37, 45, 128),   # convnext_base's stage 1 (NB = 1, no padded channel)
    (2, 19, 23, 256),   # its stage 2 (NB = 2)
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TRAIN_UNFUSED_SHAPES)
def test_unfused_rounding_training_modes_match_their_plain_versions(shape):
    """K1's save mode and K2 in their unfused-rounding modes (the bf16
    training step's stages 1-2) on the card: y, d and z against
    ``convnext_block`` with a drop-path draw (zeros among it) on the card,
    K2's dx and nine gradients against its twin
    (``fused_block_bwd_reference(..., unfused_rounding=True)``), each
    within the kernel tolerance; y with s of ones bit-equal to the serving
    unfused-rounding mode; two K2 calls bit-equal; each call counted on its
    mode's counter."""
    _need_card()
    from audioset_convnext_inf_torch.ops.nhwc import convnext_block

    x, args, _ = _unfused_case(shape, 9)
    rng = np.random.RandomState(10)
    b = shape[0]
    s = torch.from_numpy(((rng.rand(b) > 0.3) / 0.9).astype(np.float32)).cuda()
    s[0] = 0.0
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda().to(torch.bfloat16)
    k1_counts = lambda: (FB.fused_block.launches, FB.fused_block.save_launches,  # noqa: E731
                         FB.fused_block.unfused_rounding_launches,
                         FB.fused_block.unfused_rounding_save_launches)
    before = k1_counts()
    y, dz = FB.fused_block(x, *args, 1e-6, s=s, save_dwconv=True, unfused_rounding=True)
    y1, _ = FB.fused_block(x, *args, 1e-6, s=torch.ones(b, device="cuda"), save_dwconv=True,
                           unfused_rounding=True)
    serving = FB.fused_block(x, *args, 1e-6, unfused_rounding=True)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(k1_counts(), before)) == (3, 2, 1, 2)
    assert dz.shape == (2, *shape) and torch.equal(y1, serving)
    y_ref, d_ref, z_ref = convnext_block(x, *args, 1e-6, "tanh", s, saves=True)
    for got, ref in ((y, y_ref), (dz[0], d_ref), (dz[1], z_ref)):
        assert got.dtype == torch.bfloat16
        assert (got.float() - ref.float()).abs().max().item() <= _tol(torch.bfloat16, ref)
    w = (args[0], *args[2:])
    before = (FBB.fused_block_bwd.launches, FBB.fused_block_bwd.unfused_rounding_launches)
    dx, g = FBB.fused_block_bwd(x, dz, dy, *w, s, 1e-6, True)
    dx2, g2 = FBB.fused_block_bwd(x, dz, dy, *w, s, 1e-6, True)
    torch.cuda.synchronize()
    assert (FBB.fused_block_bwd.launches, FBB.fused_block_bwd.unfused_rounding_launches) == (
        before[0] + 2, before[1] + 2)
    dx_ref, g_ref = FBB.fused_block_bwd_reference(x, dz, dy, *w, s, 1e-6, True)
    assert dx.dtype == torch.bfloat16 and torch.equal(dx, dx2)
    assert (dx.float() - dx_ref.float()).abs().max().item() <= _tol(torch.bfloat16, dx_ref)
    for k in g_ref:
        assert (g[k] - g_ref[k]).abs().max().item() <= _tol(torch.bfloat16, g_ref[k]), k
        assert torch.equal(g[k], g2[k]), k


@pytest.mark.cuda
def test_a_traced_bf16_training_step_runs_stages_1_2_in_the_unfused_rounding_modes():
    """One profiled training step of convnext_tiny in the fused bf16 recipe
    (1-s clips): K1's save mode and K2 once a block, 18 each, of them 6
    each in the unfused-rounding modes (stages 1-2), and K1's serving
    unfused-rounding mode never; one prep span a launch of either."""
    _need_card()
    from torch.autograd import DeviceType

    from audioset_convnext_inf_torch.engine.trainer import TrainConfig, Trainer
    from audioset_convnext_inf_torch.models import convnext_tiny

    model = convnext_tiny(drop_path_rate=0.1, block_impl="xla_approx", fused_train_blocks=True,
                          seed=0)
    trainer = Trainer(model, TrainConfig(bf16_compute=True, mixup_alpha=1.0))
    rng = np.random.RandomState(4)
    pcm = (rng.randn(8, 32000) * 3000).astype(np.int16)
    target = (rng.rand(8, 527) < 0.05).astype(np.float32)
    trainer.step(pcm, target)  # builds and warms up
    torch.cuda.synchronize()
    counters = ((FB.fused_block, "save_launches"), (FB.fused_block, "unfused_rounding_launches"),
                (FB.fused_block, "unfused_rounding_save_launches"), (FBB.fused_block_bwd, "launches"),
                (FBB.fused_block_bwd, "unfused_rounding_launches"))
    for f, k in counters:
        setattr(f, k, 0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        loss = trainer.step(pcm, target)
        torch.cuda.synchronize()
    assert np.isfinite(loss)
    assert tuple(getattr(f, k) for f, k in counters) == (18, 0, 6, 18, 6)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    assert names.count("fused_block.prep") == names.count("fused_block_bwd.prep") == 18


WIDTHS = (1, 100, 160, 192, 256, 320, 384, 512, 640, 768, 1024)


@pytest.mark.cuda
def test_launch_plans_agree_with_the_kernels():
    """Each plan's shared memory is what the kernel computes for it, the
    kernels refuse a plan they cannot run, and the wrapper raises on a
    refused launch."""
    _need_card()
    k1, k2 = FB._lib(), FBB._lib()

    def k1_smem(c, code, npix, p):
        return k1.fused_block_plan_smem(c, code, npix, p.mt, p.cp, p.out_split, p.hidden_split,
                                        p.per, p.stages)

    for c in WIDTHS:
        for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            for npix in (217, 1736, 3472, 14112):
                p = FB.launch_plan(c, dt, npix)
                assert k1_smem(c, code, npix, p) == p.smem_bytes, (c, dt, npix)
                assert k1_smem(c, code, npix, p._replace(mt=48)) == -1
                if code:
                    for bad in (p._replace(hidden_split=p.hidden_split + 1),
                                p._replace(out_split=p.out_split + 1),
                                p._replace(stages=p.stages - 1)):
                        assert k1_smem(c, code, npix, bad) == -1, (c, npix, bad)
            q = FBB.launch_plan(c, dt, 16, 31, 7)
            assert k2.fused_block_bwd_plan_smem(c, code, q.mt, q.cp) == q.chain_smem, (c, dt)
            assert k2.fused_block_bwd_plan_smem(c, code, q.mt, q.cp + 8) == -1
            if code:
                assert k2.fused_block_bwd_ln_smem(q.cp) == q.ln_smem
    assert k2.fused_block_bwd_wgrad_smem() == FBB.WGRAD_SMEM
    for h, w in ((63, 14), (31, 7), (5, 4), (100, 70)):
        for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            st = FBB.launch_plan(96, dt, 2, h, w).stencil
            assert k2.fused_block_bwd_stencil_smem(h, w, code, st.th, st.tw) == st.smem
            assert k2.fused_block_bwd_stencil_smem(h, w, code, st.th + 1, st.tw) == -1
    rng = np.random.RandomState(3)
    args = _block_args(rng, 384)
    x = torch.from_numpy(rng.randn(2, 5, 5, 384).astype(np.float32)).cuda().to(torch.bfloat16)
    bad = FB.launch_plan(384, torch.bfloat16, 50)._replace(mt=32)
    with pytest.raises(RuntimeError, match="cudaError"):
        FB._forward_cuda(x, *args, 1e-6, None, False, bad)
    xb, d, dy, w, s = _bwd_case(rng, (2, 5, 5, 384), torch.bfloat16)
    q = FBB.launch_plan(384, torch.bfloat16, 2, 5, 5)
    stencil = q.stencil._replace(th=q.stencil.th - 1)
    for bad in (q._replace(split_px=96), q._replace(ksplit=0), q._replace(stencil=stencil)):
        with pytest.raises(RuntimeError, match="cudaError"):
            FBB._backward_cuda(xb, d, dy, *w, s, 1e-6, bad)


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
    assert FB.fused_block.launches == sum(model.cfg.depths)


@pytest.mark.cuda
def test_a_traced_bf16_forward_holds_a_prep_span_per_fused_block():
    """Under the profiler, convnext_tiny's bf16 forward shows one
    ``fused_block.prep`` range a K1 launch (3 + 3 blocks in the
    unfused-rounding mode, 9 + 3 in K1's own), one span each of the
    frontend and the four stages, and the card's kernels."""
    _need_card()
    from torch.autograd import DeviceType

    from audioset_convnext_inf_torch.models import convnext_tiny

    with pytest.warns(UserWarning, match="auto-switched"):
        model = convnext_tiny(compute_dtype=torch.bfloat16)
    pcm = np.zeros((2, 32000), np.int16)
    model.forward(pcm)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    FB.fused_block.launches = FB.fused_block.unfused_rounding_launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        model.forward(pcm)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    assert names.count("fused_block.prep") == FB.fused_block.launches == 18
    assert FB.fused_block.unfused_rounding_launches == 6
    for span in ("model.frontend", "model.stage1", "model.stage2", "model.stage3",
                 "model.stage4"):
        assert names.count(span) == 1, span
    assert any(e.device_type == DeviceType.CUDA for e in prof.events())


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
        assert FB.fused_block.launches == sum(model.cfg.depths)
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
    assert FB.fused_block.launches == 3 * sum(model.cfg.depths)
    np.testing.assert_array_equal(out["target"], target)
    ref = np.concatenate([
        model.forward(np.pad(pcm[s:s + 4], ((0, 4 - len(pcm[s:s + 4])), (0, 0))))
        ["clipwise_output"].cpu().numpy()[:len(pcm[s:s + 4])] for s in range(0, 11, 4)])
    np.testing.assert_array_equal(out["clipwise_output"], ref)


@pytest.mark.cuda
def test_service_on_the_card_gives_each_clip_its_own_result():
    """The batcher's card path (pinned slab rings, the copy stream, results
    copied back under their own event) with 8 threads sending 192 distinct
    int16 clips through batches of 8. The model records each batch as the
    card received it: every clip is in exactly one batch, intact (a slab
    rewritten before its copy completed would break that), the other rows
    are padding, each answer is its row of that batch's output, and each
    batch's output is model.forward of that batch, bit for bit: the service
    computes on its own streams, and a batch's answer does not depend on
    the stream (test_a_clips_answer_does_not_depend_on_its_batch_neighbours).
    K1 runs for every batch and no other time."""
    _need_card()
    from concurrent.futures import ThreadPoolExecutor

    from audioset_convnext_inf_torch.engine.service import InferenceService
    from audioset_convnext_inf_torch.models import convnext_atto

    with pytest.warns(UserWarning, match="auto-switched"):
        model = convnext_atto(compute_dtype=torch.bfloat16, seed=5)

    class Recording:
        device = model.device

        def __init__(self):
            self.batches = []

        def forward(self, x):
            out = model.forward(x)
            self.batches.append((x.clone(), out["clipwise_output"].clone()))
            return out

    rec = Recording()
    pcm = (np.random.RandomState(2).randn(192, 32000) * 3000).astype(np.int16)
    with InferenceService(rec, batch_size=8, max_wait_ms=2, clip_samples=32000,
                          pcm_int16=True) as svc:
        FB.fused_block.launches = 0
        rec.batches.clear()  # the warm-up's
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(lambda i: svc.tag(pcm[i], timeout=60)["clipwise_output"],
                                range(192)))
        torch.cuda.synchronize()
    assert FB.fused_block.launches == len(rec.batches) * sum(model.cfg.depths)
    where = {}
    for k, (x, _) in enumerate(rec.batches):
        rows = x.cpu().numpy()
        for r, row in enumerate(rows):
            hits = np.flatnonzero((pcm == row).all(axis=1))
            assert len(hits) == 1 or not row.any(), (k, r)
            if len(hits):
                assert hits[0] not in where, hits[0]
                where[hits[0]] = (k, r)
        ref = model.forward(x)["clipwise_output"]
        assert torch.equal(ref, rec.batches[k][1]), k
    assert sorted(where) == list(range(192))
    for i, probs in enumerate(got):
        k, r = where[i]
        np.testing.assert_array_equal(probs, rec.batches[k][1][r].cpu().numpy())


def _row0_layers(model, pcm, row=0):
    """{layer: row ``row`` of its output} of model.forward on the int16
    batch ``pcm``: the frontend's power spectrum and mel product (sub-steps
    of "frontend"), then each layer that ``forward``'s tap sees."""
    from audioset_convnext_inf_torch.models import convnext as F
    from audioset_convnext_inf_torch.ops import frontend as FE
    from audioset_convnext_inf_torch.ops.pcm import decode_pcm_if_int16

    rows = {}

    def tap(name, x):
        rows[name] = x[row].float().cpu().clone()

    with torch.inference_mode():
        x = decode_pcm_if_int16(torch.from_numpy(pcm).to(model.device))
        fe = model.frontend
        power = FE.power_spectrogram_conv(x, fe.cfg, fe.dft_weight)
        tap("frontend: power spectrum", power)
        tap("frontend: mel product", FE._matmul(power, fe.mel_weights.t(), fe.cfg.precision))
        F.forward(model, x, model.cfg, fe, model.compute_dtype, tap=tap)
    return rows


def _first_parting(a, b):
    """(first layer whose row 0 differs, its max abs diff), or None."""
    for name in a:
        if not torch.equal(a[name], b[name]):
            return name, (a[name] - b[name]).abs().max().item()
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("name,seconds", [("convnext_atto", 1), ("convnext_tiny", 10)])
def test_a_clips_answer_does_not_depend_on_its_batch_neighbours(name, seconds):
    """bf16 serving (tanh GELU, frontend "default", conv DFT), B=16: row 0
    holds the same clip while rows 1..15 hold zeros or two sets of other
    clips. Row 0 of every layer's output must be bit-equal across the three
    batches; the same batch must repeat bit-exactly on one stream, and on
    a compute stream beside a copy stream (the service's two streams).
    Reported beside: where the clip's answer parts when it moves to another
    row, or into a batch of 8."""
    _need_card()
    from audioset_convnext_inf_torch import models

    with pytest.warns(UserWarning, match="auto-switched"):
        model = models.MODEL_REGISTRY[name](compute_dtype=torch.bfloat16, seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():  # gamma 1e-6 at init would make every block the identity
        for stage in model.stages:
            for blk in stage:
                blk.gamma.copy_(torch.rand(blk.gamma.shape, generator=g) * 0.9 + 0.1)
    rng = np.random.RandomState(5)
    n = 32000 * seconds
    pcm = lambda: (rng.randn(16, n) * 3000).astype(np.int16)  # noqa: E731
    a, b, c = np.zeros((16, n), np.int16), pcm(), pcm()
    b[0] = c[0] = a[0] = pcm()[0]
    rows = {k: _row0_layers(model, x) for k, x in (("zeros", a), ("others", b), ("others 2", c))}
    parted = {k: _first_parting(rows["zeros"], rows[k]) for k in ("others", "others 2")}
    parted["others vs others 2"] = _first_parting(rows["others"], rows["others 2"])
    again = _first_parting(rows["others"], _row0_layers(model, b))
    # reported, not asserted: the clip at row 5 instead of 0 (the service
    # puts a clip at any row), and row 0 in a batch of 8 (what a sharded
    # evaluation over two replicas gives each replica) against 16
    moved = b.copy()
    moved[[0, 5]] = b[[5, 0]]
    other = {"row 5": _row0_layers(model, moved, row=5), "B=8": _row0_layers(model, b[:8])}
    where = {k: _first_parting(rows["others"], v) for k, v in other.items()}
    probs = {k: (torch.sigmoid(v["head"]) - torch.sigmoid(rows["others"]["head"])).abs().max().item()
             for k, v in other.items()}

    copy, compute = torch.cuda.Stream(), torch.cuda.Stream()
    host = torch.from_numpy(b).pin_memory()
    with torch.cuda.stream(copy):
        x = host.to(model.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(copy)
    with torch.cuda.stream(compute):
        compute.wait_event(done)
        x.record_stream(compute)
        side = model.forward(x)["clipwise_output"]
    torch.cuda.synchronize()
    main = model.forward(b)["clipwise_output"]
    streams = (side - main).abs().max().item()
    print(f"\n{name}, {seconds}-s clips, B=16: first layer whose row 0 parts "
          f"{parted}; the same batch again {again}; two streams max diff {streams:.3e}; "
          f"the same clip at row 5, and at B=8: first parting {where}, probabilities max "
          f"diff {probs}; "
          f"layers {list(rows['zeros'])}")
    assert all(v is None for v in parted.values()), parted
    assert again is None and streams == 0.0


@pytest.mark.cuda
def test_pann_bf16_route_on_the_card_at_ten_seconds():
    """Wavegram-Logmel-CNN14's bf16 route on the card (cuDNN's fused
    convolution, bias and ReLU) on eight 10-s clips against the benchmark's
    plain reference, the float8 control failing the same tolerance, and the
    route's counter."""
    import json

    from audioset_convnext_inf_torch.models.pann import create_pann_model
    from benchmark import clips
    from benchmark.reference import pann as ref
    from benchmark.reference.pann_weights import make_state_dict
    from benchmark.spec import HERE

    _need_card()
    with open(HERE / "configs" / "wavegram_logmel_cnn14-bf16-serve.json") as f:
        mcfg = json.load(f)["model"]
    sd = make_state_dict(mcfg, 18, "cuda")
    model = create_pann_model(mcfg["name"], device="cuda", compute_dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    pcm = torch.from_numpy(clips.pool(18, 8, 320000, "cuda")).cuda()
    got = model.forward(pcm)["clipwise_output"].float()
    want = ref.probabilities(sd, pcm, mcfg, block_rows=4)
    f8 = ref.probabilities(sd, pcm, mcfg, quant=torch.float8_e4m3fn, block_rows=4)
    gap, control = float((got - want).abs().max()), float((f8 - want).abs().max())
    print(f"bf16 route gap {gap:.4g}, float8 control {control:.4g}")
    assert gap < 1e-2 < control  # tests/test_torch_pann_serving.py's bf16 tolerance
    assert (model.bf16_forwards, model.f32_forwards) == (1, 0)
