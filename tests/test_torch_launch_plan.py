"""The launch plans of the fused block kernels (K1 forward, K2 backward):
plain functions of (C, dtype, pixel count; K2 the image shape) that choose
K1's pixel tiles, clusters, output slices, hidden ranges and weight ring,
the channel padding of the bf16 tiles, the splits of K2's products, its
stencil tile and the workspaces. Held here, for every stage-3/4 width of
the seven factories and C = 1 and 100, to what an H100 block can have
(232,448 bytes of shared memory, 65,536 registers an SM: K1's consumer
threads within their setmaxnreg budget, K2's accumulators at most 128 a
thread) and to what the wrappers allocate. The kernels' own agreement with
the plans (the shared memory each computes, refusing other plans) is
checked on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from audioset_convnext_inf_torch.ops import fused_block as FB
from audioset_convnext_inf_torch.ops import fused_block_bwd as FBB

WIDTHS = (1, 100, 160, 192, 256, 320, 384, 512, 640, 768, 1024)
SMEM = 232_448
SHAPES = {"tiny stage 3": (16, 63, 14), "tiny stage 4": (16, 31, 7), "ragged": (3, 5, 7)}
NPIX = {k: b * h * w for k, (b, h, w) in SHAPES.items()}
# chip_smoke.py's K2_CASES (B, H, W, C) and widths around them
K2_SHAPES = [(16, 63, 14, 384), (16, 31, 7, 768), (8, 63, 14, 384), (8, 31, 7, 768),
             (16, 63, 14, 160), (4, 13, 14, 100)]
K2_WIDTHS = (1, 100, 160, 384, 768, FB.MAX_C)


def _k1_ranges(p):
    """K1's hidden ranges as lists of 128-unit chunks, in range order."""
    return [list(range(z * p.per, min((z + 1) * p.per, p.chunks))) for z in range(p.hidden_split)]


@pytest.mark.parametrize("c", WIDTHS)
def test_forward_plan_fits_one_block(c):
    """Every K1 plan fits one H100 block: shared memory (with the static
    part the kernel may add), the consumers' accumulators within their
    setmaxnreg budget and the three warpgroups within the SM's registers;
    at CP = 128 two blocks fit an SM, shared memory and registers; its
    tiles cover every pixel once (in whole clusters), its output slices
    every channel and its hidden ranges every chunk that holds a real
    hidden unit once; the plan is a function of C and the pixel count
    alone."""
    assert 2 * 128 * FB.CONSUMER_REGS + 128 * FB.PRODUCER_REGS <= 65536
    # setmaxnreg.inc takes only what the block's own producer released: 168
    # (one block an SM) or 80 (two) registers a thread at launch
    for launch, cons, prod in ((168, FB.CONSUMER_REGS, FB.PRODUCER_REGS),
                               (80, FB.NARROW_CONSUMER_REGS, FB.NARROW_PRODUCER_REGS)):
        assert launch == 65536 // (FB.THREADS * (2 if launch == 80 else 1)) // 8 * 8
        assert 2 * 128 * (cons - launch) <= 128 * (launch - prod)
    for dt in (torch.float32, torch.bfloat16):
        for npix in NPIX.values():
            p = FB.launch_plan(c, dt, npix)
            assert p == FB.launch_plan(c, dt, npix)
            if dt == torch.float32:
                assert p.smem_bytes <= SMEM and p.acc_regs <= 128, p
                assert p.ctas * p.mt >= npix > (p.ctas - 1) * p.mt
                assert p.cp == c and (p.out_split, p.hidden_split) == (1, 1)
                continue
            assert p.smem_bytes + FB.STATIC_RESERVE <= SMEM, p
            assert p.sm_blocks == (2 if p.cp == 128 else 1)
            assert p.sm_blocks * (p.smem_bytes + FB.STATIC_RESERVE + 1024) <= FB.SM_SMEM, p
            regs = FB.NARROW_CONSUMER_REGS if p.sm_blocks == 2 else FB.CONSUMER_REGS
            assert p.acc_regs + FB.H_REGS <= regs, p
            assert p.cp % FB.CPAD == 0 and 0 <= p.cp - c < FB.CPAD
            # pixels: 64-pixel tiles, whole clusters of two, no tile without a pixel but the pad
            assert p.mt == 64 and p.tiles % FB.CLUSTER == 0
            tiles = -(-npix // 64)
            assert p.tiles - tiles == tiles % 2
            # output channels: slices of 128 * out_blocks cover cp, none empty
            width = 128 * p.out_blocks
            assert p.out_split * width >= p.cp > (p.out_split - 1) * width
            assert p.acc_regs == width // 4  # (64, width / 2) f32 a warpgroup
            # hidden units: the ranges take every 128-unit chunk with a real
            # hidden unit once, in order; the chunks past 4C (zero weights) none
            ranges = _k1_ranges(p)
            assert p.chunks == -(-4 * c // FB.NH) and (p.chunks - 1) * FB.NH < 4 * c
            assert sum(ranges, []) == list(range(p.chunks)) and all(ranges)
            assert p.ctas == p.tiles * p.out_split * p.hidden_split
            assert [k for k, _ in p.launches] == ["fused_block_wgmma_kernel"] + (
                ["fused_block_sum_kernel"] if p.hidden_split > 1 else [])
            assert p.launches[0][1] == p.ctas
            # the weight ring: at least the NB boxes of a k-slice of W2 and one W1 box
            assert p.stages >= p.out_blocks
@pytest.mark.parametrize("c", WIDTHS)
def test_backward_plan_fits_one_block_and_its_workspaces_are_allocated(c):
    for dt in (torch.float32, torch.bfloat16):
        for shape in SHAPES.values():
            npix = shape[0] * shape[1] * shape[2]
            q = FBB.launch_plan(c, dt, *shape)
            bf = dt == torch.bfloat16
            assert max(q.chain_smem, q.wgrad_smem, q.ln_smem, q.stencil.smem) <= SMEM, (dt, q)
            assert q.acc_regs <= 128, (dt, q)
            mtiles = -(-npix // q.mt)
            assert mtiles * q.mt >= npix > (mtiles - 1) * q.mt
            # bf16: a chain block per 128 pixels and 128 of the 4cp hidden units
            assert q.chain_ctas == (4 * q.cp // 128 if bf else 1) * mtiles
            # the split ranges cover every pixel once, none of them empty
            assert q.split_px % 64 == 0 or not bf
            assert q.split * q.split_px >= npix > (q.split - 1) * q.split_px
            # the ksplit ranges of dxn's 4cp reduction: whole 64-deep steps, none empty
            steps = 4 * q.cp // 64
            per = -(-steps // q.ksplit)
            assert q.ksplit == 1 or (bf and (q.ksplit - 1) * per < steps)
            # what the kernel source documents, in elements
            st = q.stencil
            want = {"xn": npix * q.cp, "dys": npix * q.cp, "dz2": npix * q.cp if bf else 0,
                    "gact": npix * 4 * q.cp, "dh1": npix * 4 * q.cp, "dd": npix * c,
                    "dxn": q.ksplit * npix * q.cp if bf else 0, "stats": 2 * npix if bf else 0,
                    "part_vec": -(-npix // q.px) * (4 if bf else 8) * c,
                    "part_db1": mtiles * 4 * c if bf else 0,
                    "part_dww": shape[0] * st.nth * st.ntw * 49 * c,
                    "part_mm": q.split * 8 * q.cp * q.cp if bf else 0}
            assert q.workspace == want
            bufs = FBB.allocate(q, c, dt, "meta")
            for k, n in want.items():
                assert bufs[k].numel() == n and bufs[k].dtype == (
                    dt if k in ("xn", "dys", "dz2", "gact", "dh1", "dd") else torch.float32), k
            assert bufs["m"].shape == (q.cp, 4 * q.cp) and bufs["dw1"].shape == (4 * q.cp, q.cp)
            # one buffer, dw1 right after m: the kernel's one sum of the splits writes both
            assert bufs["m"].is_contiguous() and bufs["dw1"].is_contiguous()
            assert bufs["m"]._base is not None and bufs["dw1"]._base is bufs["m"]._base
            assert bufs["dw1"].storage_offset() == bufs["m"].storage_offset() + 4 * q.cp * q.cp
            assert [bufs[k].shape for k in ("sdys", "dlnb", "dlns", "dbdw", "db1")] == [
                (c,)] * 4 + [(4 * c,)] and bufs["dww"].shape == (c, 1, 7, 7)
            # each sum its own tensor: the custom op's outputs may not share storage
            outs = [bufs[k] for k in ("sdys", "dlnb", "dlns", "dbdw", "db1", "dww", "m")]
            assert len({t.untyped_storage().data_ptr() for t in outs}) == len(outs) or \
                bufs["m"].device.type == "meta"


@pytest.mark.parametrize("dt", (torch.bfloat16, torch.float32))
def test_backward_launches_match_the_plan(dt):
    """The plan lists each launch of a call with its blocks: seven in bf16
    (CUDA_LAUNCHES, what chip_smoke.py's profile of one call shows), five in
    f32; the sums' launch has a segment per output (sum dy*s, dlnb, dlns,
    db_dw, db1, dW_dw and, in bf16, M | dW1) and a block per cpt * 256 / g
    of its columns: g = 1, 2, ..., 32 threads a column, at most the
    segment's rows, and cpt = 4 columns a thread up to 8 rows, else 1."""
    for b, h, w, c in K2_SHAPES:
        q = FBB.launch_plan(c, dt, b, h, w)
        names = [n for n, _ in q.launches]
        if dt == torch.bfloat16:
            assert len(q.launches) == FBB.CUDA_LAUNCHES == 7
            assert names == ["prep_kernel", "chain_h_kernel", "gemm_kernel", "ln_bwd_kernel",
                             "gemm_kernel", "dw_bwd_kernel", "sum_parts_kernel"]
            assert [n for _, n in q.launches][1:3] == [q.chain_ctas, q.dxn_ctas]
            assert q.launches[4][1] == q.wgrad_ctas
        else:
            assert names == ["chain_kernel", "wgrad_gemm_kernel", "wgrad_gemm_kernel",
                             "dw_bwd_kernel", "sum_parts_kernel"]
        assert q.launches[-2][1] == q.stencil_ctas
        bf = dt == torch.bfloat16
        npix = b * h * w
        vec_rows = -(-npix // q.px)
        segments = [(vec_rows, c)] * 4 + [(-(-npix // q.mt), 4 * c)] + [
            (b * q.stencil.nth * q.stencil.ntw, 49 * c)] + ([(q.split, 8 * q.cp * q.cp)] if bf else [])
        blocks = 0
        for rows, n in segments:
            g = max(x for x in (1, 2, 4, 8, 16, 32) if x <= rows)
            blocks += -(-n // ((4 if rows <= 8 else 1) * 256 // g))
        assert q.launches[-1][1] == blocks


@pytest.mark.parametrize("b,h,w,c", K2_SHAPES)
@pytest.mark.parametrize("dt", (torch.bfloat16, torch.float32))
def test_stencil_tiles_cover_every_pixel_and_channel(b, h, w, c, dt):
    """The stencil launch's tiles cover each image's pixels once, in even
    pieces of at most 16 rows and 32 columns, and its 64-channel slabs
    every channel, at every width of K2_WIDTHS too; a tile's staging (dd
    with a 3-pixel halo, and x) stays within the 110-KiB cap, two blocks an
    SM."""
    for cc in (c,) + K2_WIDTHS:
        q = FBB.launch_plan(cc, dt, b, h, w)
        st = q.stencil
        assert st.nth * st.th >= h > (st.nth - 1) * st.th and st.th <= 16
        assert st.ntw * st.tw >= w > (st.ntw - 1) * st.tw and st.tw <= 32
        slabs = -(-cc // FBB.SLAB)
        assert slabs * FBB.SLAB >= cc > (slabs - 1) * FBB.SLAB
        assert q.stencil_ctas == b * st.nth * st.ntw * slabs
        esize = 2 if dt == torch.bfloat16 else 4
        staging = ((st.th + 6) * (st.tw + 6) + st.th * st.tw) * 64 * esize
        assert staging <= 112640 and st.smem == staging + 49 * 64 * 4
    # wide and tall images take several tiles each way
    st = FBB.stencil_tile(100, 70, 4)
    assert (st.ntw, st.tw) == (3, 24) and st.nth * st.th >= 100 and st.smem <= 112640 + 49 * 256


def _stencil_by_tiles(x, dd, wdw, th, tw):
    """The kernel's staging and index arithmetic, tile by tile, in f64:
    dd staged with a 3-pixel halo of zeros (staged row r + 6 - ky, column q
    + 6 - kx for output (r, q) and tap (ky, kx)); dx = sum_taps w * dd, and
    the tiles' partials of sum x * dd added in tile order."""
    b, h, w, c = x.shape
    dx = np.zeros_like(x)
    parts = []
    for img in range(b):
        for h0 in range(0, h, th):
            for w0 in range(0, w, tw):
                ds = np.zeros((th + 6, tw + 6, c))
                for sr in range(th + 6):
                    for sq in range(tw + 6):
                        hh, ww = h0 - 3 + sr, w0 - 3 + sq
                        if 0 <= hh < h and 0 <= ww < w:
                            ds[sr, sq] = dd[img, hh, ww]
                xs = np.zeros((th, tw, c))
                rows, cols = min(th, h - h0), min(tw, w - w0)
                xs[:rows, :cols] = x[img, h0:h0 + rows, w0:w0 + cols]
                acc = np.zeros((th, tw, c))
                part = np.zeros((7, 7, c))
                for ky in range(7):
                    for kx in range(7):
                        win = ds[6 - ky:6 - ky + th, 6 - kx:6 - kx + tw]
                        acc += wdw[ky, kx] * win
                        part[ky, kx] = (xs * win).sum((0, 1))
                dx[img, h0:h0 + rows, w0:w0 + cols] = acc[:rows, :cols]
                parts.append(part)
    return dx, sum(parts)


@pytest.mark.parametrize("b,h,w,c", [(1, 63, 14, 3), (1, 31, 7, 2), (2, 13, 14, 3),
                                     (1, 40, 70, 2), (1, 5, 4, 1)])
def test_stencil_tiling_gives_both_depthwise_gradients(b, h, w, c):
    """The tiles of the bf16 plan, emulated with the kernel's index
    arithmetic, give dx = the flipped-kernel convolution of dd and dW_dw =
    sum x(shifted) * dd of the whole image (the plain version's two
    stencils), halos and ragged edge tiles included."""
    rng = np.random.RandomState(h * w + c)
    x, dd = rng.randn(b, h, w, c), rng.randn(b, h, w, c)
    wdw = rng.randn(7, 7, c)
    st = FBB.launch_plan(c, torch.bfloat16, b, h, w).stencil
    dx, dww = _stencil_by_tiles(x, dd, wdw, st.th, st.tw)
    ddt = torch.from_numpy(dd).permute(0, 3, 1, 2)
    flipped = torch.from_numpy(wdw).permute(2, 0, 1).flip(-1, -2)[:, None]
    want = torch.nn.functional.conv2d(ddt, flipped, padding=3, groups=c).permute(0, 2, 3, 1)
    np.testing.assert_allclose(dx, want.numpy(), rtol=1e-10, atol=1e-10)
    xp = np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)))
    want_w = np.stack([np.stack([(xp[:, ky:ky + h, kx:kx + w] * dd).sum((0, 1, 2))
                                 for kx in range(7)]) for ky in range(7)])
    np.testing.assert_allclose(dww, want_w, rtol=1e-10, atol=1e-10)


def test_main_path_plans():
    """The two main-path shapes in bf16 take no weight padding. K1: 64-pixel
    tiles in clusters of two that share every weight box; stage 3 one
    output slice (222 blocks, 1.7 waves of the 132 SMs), stage 4 two
    slices of 384 channels (112 blocks: 108 or more SMs busy), no hidden
    split at B=16; 262 MB and 396 MB of weights read from L2 a call,
    against the 521 MB and 1.03 GB of the mma.sync kernel's 221 and 109
    blocks that each read all of W1 and W2. K2: the chain as 128-pixel x
    128-hidden-unit wgmma blocks (1332 and 672), the dxn product whole at
    stage 3 (333 blocks) and in two reduction ranges at stage 4 (336), so
    both fill the card's 132 SMs; seven and two pixel ranges of the
    weight-gradient products (252 and 288 blocks per product)."""
    s3, s4 = SHAPES["tiny stage 3"], SHAPES["tiny stage 4"]
    p3 = FB.launch_plan(384, torch.bfloat16, NPIX["tiny stage 3"])
    p4 = FB.launch_plan(768, torch.bfloat16, NPIX["tiny stage 4"])
    assert (p3.mt, p3.cp, p3.ctas, p3.out_split, p3.hidden_split, p3.stages) == (
        64, 384, 222, 1, 1, 9)
    assert (p4.mt, p4.cp, p4.ctas, p4.out_split, p4.hidden_split, p4.stages) == (
        64, 768, 112, 2, 1, 6)
    assert p3.acc_regs == p4.acc_regs == 96 and p4.ctas >= 108
    assert (p3.l2_weight_bytes, p4.l2_weight_bytes) == (261_881_856, 396_361_728)
    old = (221 * 8 * 384 ** 2 * 2, 109 * 8 * 768 ** 2 * 2)  # every block read all of W1 and W2
    assert p3.l2_weight_bytes < old[0] / 1.9 and p4.l2_weight_bytes < old[1] / 2.5
    # one clip (B=1) at stage 4: 4 tiles x 2 slices, the hidden units in 12 ranges
    clip = FB.launch_plan(768, torch.bfloat16, 31 * 7)
    assert (clip.ctas, clip.hidden_split, clip.per) == (96, 12, 2)
    q3, q4 = FBB.launch_plan(384, torch.bfloat16, *s3), FBB.launch_plan(768, torch.bfloat16, *s4)
    assert (q3.mt, q3.chain_ctas, q3.ksplit, q3.dxn_ctas, q3.split, q3.wgrad_ctas) == (
        128, 1332, 1, 333, 7, 2 * 252)
    assert (q4.mt, q4.chain_ctas, q4.ksplit, q4.dxn_ctas, q4.split, q4.wgrad_ctas) == (
        128, 672, 2, 336, 2, 2 * 288)
    for q in (q3, q4):
        assert min(q.chain_ctas, q.dxn_ctas) >= 2 * FBB.SMS
    assert (q3.stencil.th, q3.stencil.tw, q3.stencil_ctas) == (16, 14, 16 * 4 * 6)
    assert (q4.stencil.th, q4.stencil.tw, q4.stencil_ctas) == (16, 7, 16 * 2 * 12)


@pytest.mark.parametrize("c,shape", [(96, (256, 252, 56)), (192, (256, 126, 28)),
                                     (96, (1, 252, 56)), (192, (1, 126, 28))])
def test_stage_1_2_plans_run_only_the_channels_there_are(c, shape):
    """At stages 1-2 of convnext_tiny (C = 96 and 192, padded to CP = 128 and
    256), K1 takes one output slice of CP channels, NB = CP / 128 blocks of
    128: the second product runs 128 and 256 output channels, where three
    blocks would run 384 (3x and 1.5x what there is). The slice's sum takes
    32 NB registers a consumer thread beside h's 32, within the setmaxnreg
    budget. The hidden units take 3 and 6 chunks of 128, not 4 and 8 (the
    padded ones would add only zeros). At C = 96 two blocks share an SM,
    each with a 3-box ring; at C = 192 one block an SM keeps its 10.
    One clip at stage 2 splits the hidden units (3528 pixels: 56 tiles, a
    fifth of the card's SMs)."""
    b, h, w = shape
    p = FB.launch_plan(c, torch.bfloat16, b * h * w)
    cp = FB.padded_c(c)
    assert (p.cp, p.out_blocks, p.out_split) == (cp, cp // 128, 1)
    assert 128 * p.out_blocks * p.out_split == cp
    assert p.acc_regs == 32 * p.out_blocks and p.acc_regs + FB.H_REGS <= FB.NARROW_CONSUMER_REGS
    assert p.smem_bytes + FB.STATIC_RESERVE <= SMEM and p.stages >= 3 * p.out_blocks
    assert p.ctas == p.tiles * p.hidden_split
    # 4C = 384 and 768 hidden units: 3 and 6 chunks of 128 (4 CP / 128 would be 4 and 8)
    assert p.chunks == 4 * c // FB.NH
    if c == 96:  # two blocks an SM: a 3-box ring in half an SM's shared memory
        assert (p.sm_blocks, p.stages) == (2, 3)
        assert 2 * (p.smem_bytes + FB.STATIC_RESERVE + 1024) <= FB.SM_SMEM
    if b == 256:  # a batch of 256 fills the card with tiles alone
        assert p.hidden_split == 1 and p.tiles >= 100 * FB.SMS
    if (b, c) == (1, 192):
        assert (p.tiles, p.hidden_split) == (56, 2)
    # the hidden ranges still take every chunk once, in order
    assert sum(_k1_ranges(p), []) == list(range(p.chunks))


@pytest.mark.parametrize("c,shape", [(96, (64, 252, 56)), (192, (64, 126, 28)),
                                     (128, (64, 252, 56)), (256, (64, 126, 28))])
def test_unfused_rounding_training_plans_at_stages_1_2(c, shape):
    """The bf16 training step's stages 1-2 at a batch of 64 (convnext_tiny's
    C = 96 and 192, padded to CP = 128 and 256; convnext_base's 128 and
    256 at its own): K1's save mode takes the plan of its serving mode (NB
    = 1 and 2, the widths its unfused-rounding save mode is built for, no
    hidden split: the tiles fill the card 20 times over), and K2's unfused-rounding mode
    the plan of its own rounding, the same seven launches, with one more
    workspace (dgamma's block sums, C a prep block) and one more segment of
    the sums' launch. Every launch fills the card's 132 SMs twice over."""
    b, h, w = shape
    npix = b * h * w
    p = FB.launch_plan(c, torch.bfloat16, npix)
    assert FB.unfused_save_fits(c) and p.cp == FB.padded_c(c) == 128 * p.out_blocks
    assert p.out_blocks in (1, 2) and p.hidden_split == 1 and p.tiles >= 20 * FB.SMS
    own = FBB.launch_plan(c, torch.bfloat16, b, h, w)
    q = FBB.launch_plan(c, torch.bfloat16, b, h, w, unfused_rounding=True)
    assert q.cp == p.cp and q.launches[:-1] == own.launches[:-1]
    assert [n for n, _ in q.launches] == [n for n, _ in own.launches]
    extra = -(-npix // q.px)
    assert q.workspace == dict(own.workspace, part_dg=extra * c)
    g = max(x for x in (1, 2, 4, 8, 16, 32) if x <= extra)
    assert q.launches[-1][1] == own.launches[-1][1] + -(-c // (256 // g))
    assert min(n for _, n in q.launches) >= 2 * FBB.SMS
    bufs = FBB.allocate(q, c, torch.bfloat16, "meta")
    assert bufs["part_dg"].numel() == extra * c and bufs["dg"].shape == (c,)
    assert "dg" not in FBB.allocate(own, c, torch.bfloat16, "meta")


# K1's hidden ranges by pixel count at the main path's widths: (first pixel
# count, ranges). Results compare bit for bit only at equal pixel counts
# (the Evaluator, the service and the bundles do): B=16 and more take one
# range at both stages, B=8 two at stage 4, one clip 6 and 12.
K1_HIDDEN_SPLITS = {
    384: [(1, 12), (641, 6), (1409, 4), (2049, 3), (2817, 2), (4097, 1)],
    768: [(1, 24), (129, 12), (257, 8), (513, 6), (641, 5), (769, 4), (1025, 3), (1409, 2),
          (2049, 1)],
}


def test_plans_refuse_what_the_kernels_cannot_run():
    """Widths and dtypes outside the kernels raise; inside, each width has
    one plan, the same for K1 and K2's chain (the kernels refuse others, on
    the card: tests/test_torch_cuda.py)."""
    for c in (0, 1025):
        with pytest.raises(ValueError, match="C="):
            FB.launch_plan(c, torch.bfloat16, 100)
        with pytest.raises(ValueError, match="C="):
            FBB.launch_plan(c, torch.float32, 4, 5, 5)
    with pytest.raises(TypeError):
        FB.launch_plan(96, torch.float16, 100)
    with pytest.raises(TypeError):
        FBB.launch_plan(96, torch.float16, 4, 5, 5)
    for c in WIDTHS:
        cp = FB.padded_c(c)
        p = FB.launch_plan(c, torch.bfloat16, 100)
        q = FBB.launch_plan(c, torch.bfloat16, 4, 5, 5)
        assert (p.mt, p.cp, p.out_blocks) == (64, cp, cp // 128 if cp < 384 else 3 if cp <= 768 else 4)
        assert (q.mt, q.cp) == (128, cp)
        assert FB.launch_plan(c, torch.float32, 100).mt == FBB.launch_plan(
            c, torch.float32, 4, 5, 5).mt == 16
    # K1's hidden split changes with the pixel count only where named
    for c, steps in K1_HIDDEN_SPLITS.items():
        seen, prev = [], None
        for npix in range(1, 5000):
            hs = FB.launch_plan(c, torch.bfloat16, npix).hidden_split
            if hs != prev:
                seen.append((npix, hs))
                prev = hs
        assert seen == steps, c
        assert FB.launch_plan(c, torch.bfloat16, 16 * (63 * 14 if c == 384 else 31 * 7)).hidden_split == 1
    # the ablation's forced split (K1_SPLIT) is the same plan with n ranges
    assert FB.launch_plan(384, torch.bfloat16, NPIX["tiny stage 3"], split=2).hidden_split == 2


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


@pytest.mark.parametrize("c,shape", [(384, (16, 63, 14)), (768, (16, 31, 7)), (100, (8, 5, 25))])
def test_split_ranges_sum_to_the_full_weight_gradient(c, shape):
    """The bf16 weight-gradient products sum split partials over the
    plan's pixel ranges in order: the ranges tile [0, npix), so the sum of
    the partials is the whole product (checked in f64 on a narrow slice)."""
    npix = shape[0] * shape[1] * shape[2]
    q = FBB.launch_plan(c, torch.bfloat16, *shape)
    rng = np.random.RandomState(0)
    a, b = rng.randn(npix, 8), rng.randn(npix, 16)
    parts = [a[s * q.split_px:(s + 1) * q.split_px].T @ b[s * q.split_px:(s + 1) * q.split_px]
             for s in range(q.split)]
    np.testing.assert_allclose(sum(parts), a.T @ b, rtol=1e-12, atol=1e-10)
    assert all(len(a[s * q.split_px:(s + 1) * q.split_px]) for s in range(q.split))


@pytest.mark.parametrize("c,npix", [(384, 882), (768, 217), (768, 1736), (100, 728)])
def test_hidden_ranges_sum_to_the_unsplit_product(c, npix):
    """Where K1 splits the hidden units (one clip, B=8 at stage 4, narrow
    widths), each range's f32 partial of gelu(h) . W2^T is added in range
    order (fused_block_sum_kernel): the ranges take every hidden unit once,
    so the sum is the unsplit product within f32 rounding (a narrow slice
    of pixels, checked against f64)."""
    p = FB.launch_plan(c, torch.bfloat16, npix)
    assert p.hidden_split > 1
    rng = np.random.RandomState(c + npix)
    hid = 4 * p.cp
    g = rng.randn(8, hid).astype(np.float32)   # gelu(h) of 8 pixels, zero beyond 4C
    g[:, 4 * c:] = 0.0
    w2 = (rng.randn(p.cp, hid) / np.sqrt(hid)).astype(np.float32)
    parts = []
    for chunks in _k1_ranges(p):
        cols = np.concatenate([np.arange(k * FB.NH, (k + 1) * FB.NH) for k in chunks])
        parts.append(g[:, cols] @ w2[:, cols].T)
    total = parts[0].copy()
    for part in parts[1:]:  # range order, in f32
        total += part
    want = g.astype(np.float64) @ w2.T.astype(np.float64)
    np.testing.assert_allclose(total, want, rtol=1e-4, atol=1e-5)
    assert sorted(np.concatenate([np.arange(k * FB.NH, (k + 1) * FB.NH)
                                  for r in _k1_ranges(p) for k in r]).tolist()) == list(range(hid))
