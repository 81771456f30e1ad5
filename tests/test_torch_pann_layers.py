"""The port's PANN blocks and deformable convolution against the JAX
package's functions.

Each block's weights come from the port's init, perturbed with seeded
values (no residual branch or deformable offset stays at its init zero),
and cross to the JAX layout through the JAX package's own converter. The
same seeded numpy inputs go into both: NCHW / NCL into the port, NHWC /
NWC into the JAX package. f32 on the CPU; tolerance ``PROB_TOL`` (1e-4
abs) on outputs of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audioset_convnext_inf_tpu.models import pann_layers as JL
from audioset_convnext_inf_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d

from audioset_convnext_inf_torch.models import layers as L
from audioset_convnext_inf_torch.models import pann_layers as P
from audioset_convnext_inf_torch.ops.deform_conv import deform_conv2d
from tests.torch_pann_util import built, close, jax_params, nchw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.RandomState(1234)


def _pair(rng, *shape, scale=1.0):
    """A seeded (B, C, ...) input as a torch tensor and as channels-last jnp."""
    x = (rng.randn(*shape) * scale).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(np.moveaxis(x, 1, -1))


def _bn():
    return JL.BnCtx(train=False)


# ---------------------------------------------------------------------------
# pools, conv1d, init helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool_type", ["avg", "max", "avg+max", "no"])
@pytest.mark.parametrize("size", [(2, 2), (1, 1), (2, 1)])
def test_pool2d(rng, pool_type, size):
    x, xj = _pair(rng, 2, 3, 9, 7)
    close(P.pool2d(x, size, pool_type), nchw(JL.pool2d(xj, size, pool_type)), label=pool_type)


@pytest.mark.parametrize("pool_type,kernel,stride,padding", [
    ("max", 3, None, 1), ("max", 4, None, 0), ("max", 3, 1, 1),
    ("avg", 3, 1, 1), ("avg", 4, None, 0),
])
def test_pool1d(rng, pool_type, kernel, stride, padding):
    x, xj = _pair(rng, 2, 3, 29)
    close(P.pool1d(x, kernel, stride, padding, pool_type),
          nchw(JL.pool1d(xj, kernel, stride, padding, pool_type)))


@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (5, 5, 1), (1, 2, 2), (3, 1, 1)])
def test_conv1d(rng, stride, padding, dilation):
    conv = built(P.conv1d, 4, 6, 3 if stride != 5 else 11, padding=padding, stride=stride,
                 dilation=dilation, bias=True, rng=rng)
    x, xj = _pair(rng, 2, 4, 40)
    w = jnp.asarray(np.transpose(conv.weight.detach().numpy(), (2, 1, 0)))
    want = JL.conv1d(xj, w, jnp.asarray(conv.bias.detach().numpy()), stride=stride,
                     padding=padding, dilation=dilation)
    close(conv(x), nchw(want))


def test_init_helpers_and_gelu(rng):
    g = torch.Generator().manual_seed(0)
    conv = torch.nn.Conv2d(30, 50, 3)
    L.init_conv_(conv, g)  # the JAX init_conv: truncated normal, std 0.02, zero bias
    assert torch.all(conv.bias == 0) and abs(conv.weight.std().item() - 0.02) < 1e-3
    lin = torch.nn.Linear(40, 600)
    L.init_linear_(lin, g)  # the JAX init_linear: the same draw
    assert torch.all(lin.bias == 0) and abs(lin.weight.std().item() - 0.02) < 1e-3
    bn = P.BatchNorm(4)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
            t.uniform_(2, 3)
    L.init_batch_norm_(bn)
    assert bn.weight.tolist() == [1.0] * 4 and bn.running_var.tolist() == [1.0] * 4
    assert bn.bias.tolist() == [0.0] * 4 and bn.running_mean.tolist() == [0.0] * 4
    ln = P.LayerNorm2d(4, 1e-6)
    with torch.no_grad():
        ln.weight.fill_(3)
        ln.bias.fill_(2)
    L.init_layer_norm_(ln)
    assert ln.weight.tolist() == [1.0] * 4 and ln.bias.tolist() == [0.0] * 4
    from audioset_convnext_inf_tpu.models import layers as JLayers

    x = (rng.randn(64) * 3).astype(np.float32)
    close(L.gelu(torch.from_numpy(x)), JLayers.gelu(jnp.asarray(x)), tol=1e-6)


def test_init_zeroes_what_the_jax_init_zeroes():
    """At init a residual block is its identity path and a deformable conv
    a regular one, as in the JAX package."""
    gen = torch.Generator().manual_seed(0)
    blocks = [P.ResnetBasicBlock(8, 8, 1, 0, False), P.ResnetBottleneck(8, 2, 1, 0, False),
              P.Res1dBlock(8, 8, 1, 0, False), P.DaiBlock(8, 8, 3)]
    for blk in blocks:
        P.init_params_(blk, gen)
    assert torch.all(blocks[0].bn2.weight == 0) and torch.all(blocks[1].bn3.weight == 0)
    assert torch.all(blocks[2].bn2.weight == 0) and torch.all(blocks[3].bn4.weight == 0)
    x = torch.randn(1, 8, 6, 6)
    torch.testing.assert_close(blocks[0](x), torch.relu(x), rtol=0, atol=0)
    d = P.DeformableConv2d(3, 4, 3)
    P.init_params_(d, gen)
    assert not d.offset_conv.weight.any() and not d.modulator_conv.weight.any()
    x = torch.randn(2, 3, 7, 5)
    close(d(x), F.conv2d(x, d.regular_conv.weight, padding=1), tol=1e-5)


# ---------------------------------------------------------------------------
# deform_conv2d
# ---------------------------------------------------------------------------


def test_deform_conv_zero_offsets_equal_conv2d(rng):
    x = torch.from_numpy(rng.randn(2, 3, 7, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(5, 3, 3, 3).astype(np.float32))
    b = torch.from_numpy(rng.randn(5).astype(np.float32))
    off = torch.zeros(2, 18, 7, 6)
    close(deform_conv2d(x, off, w, b), F.conv2d(x, w, b, padding=1), tol=1e-5)
    w5 = torch.from_numpy(rng.randn(4, 3, 5, 5).astype(np.float32))
    close(deform_conv2d(x, torch.zeros(2, 50, 7, 6), w5, padding=(2, 2)),
          F.conv2d(x, w5, padding=2), tol=1e-5)


def test_deform_conv_integer_offset_shifts(rng):
    """Every tap moved by (dy, dx) = (1, -2) is the convolution of the map
    shifted by that much, zero where the shift leaves the map."""
    x = torch.from_numpy(rng.randn(1, 2, 8, 9).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 2, 3, 3).astype(np.float32))
    off = torch.zeros(1, 18, 8, 9)
    off[:, 0::2] = 1.0
    off[:, 1::2] = -2.0
    # tap (i, j) at p reads x[p + (i - 1 + 1, j - 1 - 2)], zero outside the map
    close(deform_conv2d(x, off, w), F.conv2d(F.pad(x, (3, -1, 0, 2)), w), tol=1e-5)


def test_deform_conv_mask_scales(rng):
    x = torch.from_numpy(rng.randn(2, 3, 6, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(4, 3, 3, 3).astype(np.float32))
    off = torch.from_numpy(rng.uniform(-1.5, 1.5, (2, 18, 6, 6)).astype(np.float32))
    base = deform_conv2d(x, off, w)
    close(deform_conv2d(x, off, w, mask=torch.full((2, 9, 6, 6), 0.5)), 0.5 * base, tol=1e-5)
    mask = torch.zeros(2, 9, 6, 6)
    mask[:, 4] = 1.0  # the centre tap alone
    w_centre = torch.zeros_like(w)
    w_centre[:, :, 1, 1] = w[:, :, 1, 1]
    close(deform_conv2d(x, off, w, mask=mask), deform_conv2d(x, off, w_centre), tol=1e-5)


@pytest.mark.parametrize("k", [3, 5])
def test_deform_conv_fractional_offsets_match_jax(rng, k):
    """Fractional, negative offsets, some reaching past the map's edge."""
    b, c, h, w, o = 2, 4, 7, 6, 5
    x = rng.randn(b, c, h, w).astype(np.float32)
    off = rng.uniform(-3.5, 3.5, (b, 2 * k * k, h, w)).astype(np.float32)
    mask = rng.uniform(0, 2, (b, k * k, h, w)).astype(np.float32)
    wt = (rng.randn(o, c, k, k) * 0.2).astype(np.float32)
    bias = rng.randn(o).astype(np.float32)
    got = deform_conv2d(torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(wt),
                        torch.from_numpy(bias), torch.from_numpy(mask), padding=(k // 2, k // 2))
    t = lambda a: jnp.asarray(np.moveaxis(a, 1, -1))  # noqa: E731
    want = jax_deform_conv2d(t(x), t(off), jnp.asarray(np.transpose(wt, (2, 3, 1, 0))),
                             jnp.asarray(bias), t(mask), padding=(k // 2, k // 2))
    close(got, nchw(want))


@pytest.mark.parametrize("k", [3, 5])
def test_deformable_conv_module_matches_jax(rng, k):
    d = built(P.DeformableConv2d, 4, 6, k)
    from tests.torch_pann_util import perturb_

    perturb_(d, rng, offset_std=0.3)
    x, xj = _pair(rng, 2, 4, 9, 8)
    off = d.offset_conv(x)
    assert off.min() < -1 and off.max() > 1 and (off.frac() != 0).all()  # fractional, both signs
    p = jax_params(d, "conv_block1.conv1.", "cnn", "conv_block1", "conv1")
    close(d(x), nchw(JL.deform_conv_apply(xj, p, k)))


# ---------------------------------------------------------------------------
# 2-D conv blocks
# ---------------------------------------------------------------------------

_CONV_BLOCKS = {
    "conv": (P.ConvBlock, JL.conv_block),
    "conv5x5": (P.ConvBlock5x5, JL.conv_block5x5),
    "sep": (P.ConvBlockSep, JL.conv_block_sep),
    "seppw": (P.ConvBlockSepPW, JL.conv_block_seppw),
}


@pytest.mark.parametrize("pool", [((2, 2), "avg"), ((2, 2), "max"), ((2, 2), "avg+max"),
                                  ((1, 1), "avg"), ((2, 1), "avg")])
@pytest.mark.parametrize("kind", sorted(_CONV_BLOCKS))
def test_conv_blocks(rng, kind, pool):
    cls, jfn = _CONV_BLOCKS[kind]
    blk = built(cls, 3, 8, rng=rng)
    x, xj = _pair(rng, 2, 3, 10, 8)
    p = jax_params(blk, "conv_block1.", "cnn", "conv_block1")
    close(blk(x, *pool), nchw(jfn(xj, p, _bn(), "b", pool_size=pool[0], pool_type=pool[1])))


@pytest.mark.parametrize("kernel", [3, 5])
def test_conv_block_deformable(rng, kernel):
    """3x3: two deformable convs; 5x5: one."""
    blk = built(P.ConvBlockDeformable, 3, 6, kernel, rng=rng)
    assert hasattr(blk, "conv2") == (kernel == 3)
    x, xj = _pair(rng, 2, 3, 9, 8)
    p = jax_params(blk, "conv_block1.", "cnn", "conv_block1")
    want = JL.conv_block_deformable(xj, p, _bn(), "b", pool_size=(2, 2), kernel=kernel)
    close(blk(x), nchw(want))


def test_att_block(rng):
    att = built(P.AttBlock, 16, 7, rng=rng)
    x, xj = _pair(rng, 2, 16, 11, scale=3.0)
    clip, norm_att, cla = att(x)
    p = jax_params(att, "att_block.", "sed", "att_block")
    jclip, jatt, jcla = JL.att_block(xj, p)
    close(clip, jclip)
    close(norm_att, nchw(jatt))
    close(cla, nchw(jcla))
    torch.testing.assert_close(norm_att.sum(-1), torch.ones(2, 7))


# ---------------------------------------------------------------------------
# 1-D blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("double", [False, True])
@pytest.mark.parametrize("stride,pool", [(3, 1), (1, 3)])
def test_lee_blocks(rng, double, stride, pool):
    cls, jfn = (P.LeeBlock2, JL.lee_block2) if double else (P.LeeBlock, JL.lee_block)
    blk = built(cls, 4, 8, 3, stride, rng=rng)
    x, xj = _pair(rng, 2, 4, 61)
    p = jax_params(blk, "conv_block1.", "leenet", "blocks", 0)
    close(blk(x, pool), nchw(jfn(xj, p, _bn(), "b", kernel=3, stride=stride, pool_size=pool)))


@pytest.mark.parametrize("in_ch,out_ch,pool", [(8, 8, 1), (8, 12, 1), (8, 12, 4)])
def test_dai_block(rng, in_ch, out_ch, pool):
    """The identity path where the shapes agree, the 1x1 downsample else."""
    blk = built(P.DaiBlock, in_ch, out_ch, 3, rng=rng)
    x, xj = _pair(rng, 2, in_ch, 33)
    p = jax_params(blk, "conv_block1.", "dainet", "blocks", 0)
    close(blk(x, pool), nchw(JL.dai_block(xj, p, _bn(), "b", kernel=3, pool_size=pool)))


def test_pre_wav_block(rng):
    blk = built(P.PreWavBlock, 4, 8, rng=rng)
    x, xj = _pair(rng, 2, 4, 64)
    p = jax_params(blk, "pre_block1.", "wavegram", "pre_block1")
    close(blk(x, 4), nchw(JL.pre_wav_block(xj, p, _bn(), "b", pool_size=4)))


# ---------------------------------------------------------------------------
# ResNet blocks and trunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stage,stride,inplanes,planes,downsample", [
    (0, 1, 8, 8, False), (1, 2, 8, 12, True), (1, 1, 12, 12, False), (0, 1, 8, 12, True),
])
def test_resnet_basic_block(rng, stage, stride, inplanes, planes, downsample):
    blk = built(P.ResnetBasicBlock, inplanes, planes, stride, stage, downsample, rng=rng)
    x, xj = _pair(rng, 2, inplanes, 8, 6)
    p = jax_params(blk, f"resnet.layer{stage + 1}.0.", "resnet", "resnet", "stages", stage, 0)
    close(blk(x), nchw(JL.resnet_basic_block(xj, p, _bn(), "b", stride, None)))


@pytest.mark.parametrize("stage,stride,inplanes,planes,downsample", [
    (0, 1, 8, 2, True), (1, 2, 8, 4, True), (1, 1, 16, 4, False),
])
def test_resnet_bottleneck(rng, stage, stride, inplanes, planes, downsample):
    blk = built(P.ResnetBottleneck, inplanes, planes, stride, stage, downsample, rng=rng)
    x, xj = _pair(rng, 2, inplanes, 8, 6)
    p = jax_params(blk, f"resnet.layer{stage + 1}.0.", "resnet", "resnet", "stages", stage, 0)
    close(blk(x), nchw(JL.resnet_bottleneck(xj, p, _bn(), "b", stride, None)))


@pytest.mark.parametrize("block_type", ["basic", "bottleneck"])
def test_resnet_forward(rng, block_type):
    trunk = built(P.Resnet, block_type, (1, 2, 1, 1), rng=rng)
    x, xj = _pair(rng, 1, 64, 16, 8)
    p = jax_params(trunk, "resnet.", "resnet", "resnet")
    fwd = jax.jit(lambda v, q: JL.resnet_forward(v, q, _bn(), "r", block_type, JL.KeyStream(None)))
    close(trunk(x), nchw(fwd(xj, p)))


@pytest.mark.parametrize("stage,stride,inplanes,planes,downsample", [
    (0, 1, 8, 8, False), (1, 4, 8, 12, True), (1, 1, 12, 12, False),
])
def test_res1d_block(rng, stage, stride, inplanes, planes, downsample):
    blk = built(P.Res1dBlock, inplanes, planes, stride, stage, downsample, rng=rng)
    x, xj = _pair(rng, 2, inplanes, 37)
    p = jax_params(blk, f"resnet.layer{stage + 1}.0.", "res1dnet", "resnet", "stages", stage, 0)
    close(blk(x), nchw(JL.res1d_block(xj, p, _bn(), "b", stride, None)))


def test_res1dnet_forward(rng):
    trunk = built(P.Res1dNet, (1, 2, 1, 1, 1, 1, 1), rng=rng)
    x, xj = _pair(rng, 1, 64, 4 ** 6)
    p = jax_params(trunk, "resnet.", "res1dnet", "resnet")
    fwd = jax.jit(lambda v, q: JL.res1dnet_forward(v, q, _bn(), "r", JL.KeyStream(None)))
    close(trunk(x), nchw(fwd(xj, p)))


# ---------------------------------------------------------------------------
# MobileNet blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2])
def test_mb_conv_bn_and_dw(rng, stride):
    cbn = built(P.mb_conv_bn, 3, 8, stride, rng=rng)
    dw = built(P.mb_conv_dw, 8, 12, stride, rng=rng)
    x, xj = _pair(rng, 2, 3, 8, 6)
    p = jax_params(cbn, "features.0.", "mobilenet_v1", "conv_bn")
    want = JL.mb_conv_bn(xj, p, _bn(), "c", stride)
    close(cbn(x), nchw(want))
    p = jax_params(dw, "features.1.", "mobilenet_v1", "blocks", 0)
    close(dw(cbn(x)), nchw(JL.mb_conv_dw(want, p, _bn(), "d", stride)))


@pytest.mark.parametrize("expand", [1, 6])
@pytest.mark.parametrize("stride,inp,oup", [(1, 8, 8), (2, 8, 8), (1, 8, 12)])
def test_inverted_residual(rng, expand, stride, inp, oup):
    """Expand ratios 1 and 6 at strides 1 and 2; the residual only where
    stride is 1 and the widths agree."""
    blk = built(P.InvertedResidual, inp, oup, stride, expand, rng=rng)
    assert blk.use_res == (stride == 1 and inp == oup)
    x, xj = _pair(rng, 2, inp, 8, 6)
    index = 0 if expand == 1 else 1  # MobileNetV2 blocks 1 and 2 have expand 1 and 6
    p = jax_params(blk, f"features.{index + 1}.", "mobilenet_v2", "blocks", index)
    close(blk(x), nchw(JL.inverted_residual(xj, p, _bn(), "i", stride, expand)))


# ---------------------------------------------------------------------------
# SED helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames", [40, 96, 100])
def test_interpolate_and_pad_framewise(rng, frames):
    """3 segments x 32 = 96 frames: padded with the last frame to 100,
    truncated to 40."""
    seg = rng.rand(2, 3, 5).astype(np.float32)
    up = P.interpolate_time(torch.from_numpy(seg), 32)
    jup = JL.interpolate_time(jnp.asarray(seg), 32)
    close(up, jup, tol=0)
    got = P.pad_framewise_output(up, frames)
    close(got, JL.pad_framewise_output(jup, frames), tol=0)
    assert got.shape == (2, frames, 5)
    if frames > 96:
        assert torch.equal(got[:, 96:], up[:, -1:].expand(-1, frames - 96, -1))
