"""The launch plans of the fused block kernels (K1 forward, K2 backward):
plain functions of (C, dtype, pixel count) that choose pixels per thread
block, the channel padding of the bf16 tiles, the split of K2's
weight-gradient products and the workspaces. Held here, for every
stage-3/4 width of the seven factories and C = 1 and 100, to what an H100
block can have (232,448 bytes of shared memory, 255 registers a thread of
which the (MT, C) accumulator takes at most 128) and to what the wrappers
allocate. The kernels' own agreement with the plans (the shared memory each
computes, refusing other plans) is checked on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from audioset_convnext_inf_torch.ops import fused_block as FB
from audioset_convnext_inf_torch.ops import fused_block_bwd as FBB

WIDTHS = (1, 100, 160, 192, 256, 320, 384, 512, 640, 768, 1024)
SMEM = 232_448
NPIX = {"tiny stage 3": 16 * 63 * 14, "tiny stage 4": 16 * 31 * 7, "ragged": 3 * 5 * 7}


@pytest.mark.parametrize("c", WIDTHS)
def test_forward_plan_fits_one_block(c):
    for dt in (torch.float32, torch.bfloat16):
        for npix in NPIX.values():
            p = FB.launch_plan(c, dt, npix)
            assert p.smem_bytes <= SMEM and p.acc_regs <= 128, (dt, p)
            assert p.ctas * p.mt >= npix > (p.ctas - 1) * p.mt
    p = FB.launch_plan(c, torch.bfloat16, NPIX["tiny stage 3"])
    assert p.cp % FB.CPAD == 0 and 0 <= p.cp - c < FB.CPAD
    assert p.acc_regs == p.mt * FB.width_class(p.cp) // 2
    assert FB.launch_plan(c, torch.float32, 100).cp == c  # the f32 kernel takes C as it is


@pytest.mark.parametrize("c", WIDTHS)
def test_backward_plan_fits_one_block_and_its_workspaces_are_allocated(c):
    for dt in (torch.float32, torch.bfloat16):
        for npix in NPIX.values():
            q = FBB.launch_plan(c, dt, npix)
            assert q.chain_smem <= SMEM and q.wgrad_smem <= SMEM and q.acc_regs <= 128, (dt, q)
            assert q.chain_ctas * q.mt >= npix > (q.chain_ctas - 1) * q.mt
            # the split ranges cover every pixel once, none of them empty
            assert q.split_px % 32 == 0 or dt == torch.float32
            assert q.split * q.split_px >= npix > (q.split - 1) * q.split_px
            # what the kernel source documents, in elements
            want = {"xn": npix * q.cp, "dys": npix * q.cp, "gact": npix * 4 * q.cp,
                    "dh1": npix * 4 * q.cp, "dd": npix * c,
                    "part_chain": -(-npix // q.mt) * 8 * c,
                    "part_wgrad": -(-npix // FBB.WGRAD_CHUNK) * 49 * c,
                    "part_mm": q.split * 8 * q.cp * q.cp if dt == torch.bfloat16 else 0}
            assert q.workspace == want
            bufs = FBB.allocate(q, c, dt, "meta")
            for k, n in want.items():
                assert bufs[k].numel() == n and bufs[k].dtype == (
                    dt if k in ("xn", "dys", "gact", "dh1", "dd") else torch.float32), k
            assert bufs["m"].shape == (q.cp, 4 * q.cp) and bufs["dw1"].shape == (4 * q.cp, q.cp)
            # one buffer, dw1 right after m: the kernel's one sum of the splits writes both
            assert bufs["m"].is_contiguous() and bufs["dw1"].is_contiguous()
            assert bufs["m"]._base is not None and bufs["dw1"]._base is bufs["m"]._base
            assert bufs["dw1"].storage_offset() == bufs["m"].storage_offset() + 4 * q.cp * q.cp
            assert bufs["vec"].shape == (8 * c,) and bufs["dww"].shape == (49, c)


def test_main_path_plans():
    """The two main-path shapes in bf16 take no weight padding; stage 3
    runs 64-pixel forward and chain blocks (221 of each) and seven split
    ranges of the weight-gradient products (252 blocks per product); stage 4
    32-pixel blocks (109 of each) and two ranges (288 per product)."""
    s3, s4 = NPIX["tiny stage 3"], NPIX["tiny stage 4"]
    p3, p4 = FB.launch_plan(384, torch.bfloat16, s3), FB.launch_plan(768, torch.bfloat16, s4)
    assert (p3.mt, p3.cp, p3.ctas, p3.acc_regs) == (64, 384, 221, 96)
    assert (p4.mt, p4.cp, p4.ctas, p4.acc_regs) == (32, 768, 109, 96)
    q3, q4 = FBB.launch_plan(384, torch.bfloat16, s3), FBB.launch_plan(768, torch.bfloat16, s4)
    assert (q3.mt, q3.chain_ctas, q3.split, q3.wgrad_ctas) == (64, 221, 7, 2 * 252)
    assert (q4.mt, q4.chain_ctas, q4.split, q4.wgrad_ctas) == (32, 109, 2, 2 * 288)


def test_plans_refuse_what_the_kernels_cannot_run():
    """Widths and dtypes outside the kernels raise; inside, each width has
    one plan, the same for K1 and K2's chain (the kernels refuse others, on
    the card: tests/test_torch_cuda.py)."""
    for c in (0, 1025):
        with pytest.raises(ValueError, match="C="):
            FB.launch_plan(c, torch.bfloat16, 100)
        with pytest.raises(ValueError, match="C="):
            FBB.launch_plan(c, torch.float32, 100)
    with pytest.raises(TypeError):
        FB.launch_plan(96, torch.float16, 100)
    with pytest.raises(TypeError):
        FBB.launch_plan(96, torch.float16, 100)
    for c in WIDTHS:
        cp, mt, ncls = FB.bf16_tiling(c)
        assert mt == (64 if cp <= 384 else 32) and mt * ncls // 2 <= 128
        p, q = FB.launch_plan(c, torch.bfloat16, 100), FBB.launch_plan(c, torch.bfloat16, 100)
        assert (p.mt, p.cp) == (q.mt, q.cp) == (mt, cp)
        assert FB.launch_plan(c, torch.float32, 100).mt == FBB.launch_plan(c, torch.float32, 100).mt == 16


@pytest.mark.parametrize("c", (1, 100, 160, 384))
def test_tile_weights_pad_with_zeros_that_change_no_product(c):
    """The zero-padded W1 (4cp, cp) and W2 (cp, 4cp) give the block's two
    products on the real channels exactly as the (4C, C) and (C, 4C) ones
    do, with xn zero beyond C and GELU(0 + 0) = 0 on the padded hidden
    units; at a width that needs no padding no copy is made."""
    rng = np.random.RandomState(c)
    w1 = torch.from_numpy(rng.randn(4 * c, c).astype(np.float32))
    w2 = torch.from_numpy(rng.randn(c, 4 * c).astype(np.float32))
    b1 = torch.from_numpy(rng.randn(4 * c).astype(np.float32))
    xn = torch.from_numpy(rng.randn(5, c).astype(np.float32))
    cp = FB.launch_plan(c, torch.bfloat16, 5).cp
    w1p, w2p = FB.tile_weights(w1, w2, torch.float32, cp)
    assert w1p.shape == (4 * cp, cp) and w2p.shape == (cp, 4 * cp)
    assert w1p.data_ptr() % 16 == 0 and w2p.data_ptr() % 16 == 0
    assert torch.equal(w1p[:4 * c, :c], w1) and torch.equal(w2p[:c, :4 * c], w2)
    assert not w1p[4 * c:].any() and not w1p[:, c:].any() and not w2p[c:].any()
    xp = torch.nn.functional.pad(xn, (0, cp - c))
    b1p = torch.nn.functional.pad(b1, (0, 4 * cp - 4 * c))
    gelu = lambda t: torch.nn.functional.gelu(t, approximate="tanh")  # noqa: E731
    y = gelu(xn.double() @ w1.double().t() + b1.double()) @ w2.double().t()
    yp = gelu(xp.double() @ w1p.double().t() + b1p.double()) @ w2p.double().t()
    torch.testing.assert_close(yp[:, :c], y, rtol=1e-12, atol=1e-12)
    if c == cp:
        wb = w1.to(torch.bfloat16)
        assert FB.tile_weights(wb, w2.to(torch.bfloat16), torch.bfloat16, cp)[0].data_ptr() \
            == wb.data_ptr()


@pytest.mark.parametrize("c,npix", [(384, 16 * 63 * 14), (768, 16 * 31 * 7), (100, 1000)])
def test_split_ranges_sum_to_the_full_weight_gradient(c, npix):
    """The bf16 weight-gradient products sum split partials over the
    plan's pixel ranges in order: the ranges tile [0, npix), so the sum of
    the partials is the whole product (checked in f64 on a narrow slice)."""
    q = FBB.launch_plan(c, torch.bfloat16, npix)
    rng = np.random.RandomState(0)
    a, b = rng.randn(npix, 8), rng.randn(npix, 16)
    parts = [a[s * q.split_px:(s + 1) * q.split_px].T @ b[s * q.split_px:(s + 1) * q.split_px]
             for s in range(q.split)]
    np.testing.assert_allclose(sum(parts), a.T @ b, rtol=1e-12, atol=1e-10)
    assert all(len(a[s * q.split_px:(s + 1) * q.split_px]) for s in range(q.split))
