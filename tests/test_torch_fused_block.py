"""The port's fused ConvNeXt block (K1) against the JAX package.

On the CPU the wrapper runs the kernel's plain version, which is held here
against the JAX package's Pallas kernel run in interpret mode (as its own
tests run it) on the HWBC-padded transpose of the same input, and against
the unfused JAX block. The CUDA kernel itself is compared with the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py. The
unfused-rounding mode's CPU leg is the port's unfused block itself,
held here bit for bit to ``models/convnext.py::_block_apply``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audioset_convnext_inf_tpu.models.convnext import _block_apply
from audioset_convnext_inf_tpu.ops.pallas_fused_block import fused_block_hwbc

from audioset_convnext_inf_torch.models.convnext import Block
from audioset_convnext_inf_torch.models.convnext import _block_apply as port_block_apply
from audioset_convnext_inf_torch.ops import fused_block as FB

K = 7


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
    """A fresh seeded stream per test, whatever ran before in the worker."""
    return np.random.RandomState(1234)


def _params(rng, c, with_gamma=True):
    """Block weights in the JAX package's layouts, with non-trivial gamma."""
    p = {
        "dwconv": {"w": rng.randn(K, K, 1, c) * 0.05, "b": rng.randn(c) * 0.05},
        "norm": {"scale": 1 + rng.randn(c) * 0.05, "bias": rng.randn(c) * 0.05},
        "pwconv1": {"w": rng.randn(c, 4 * c) * 0.03, "b": rng.randn(4 * c) * 0.03},
        "pwconv2": {"w": rng.randn(4 * c, c) * 0.03, "b": rng.randn(c) * 0.03},
    }
    if with_gamma:
        p["gamma"] = rng.randn(c) * 0.2 + 0.5
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


def _torch_args(p):
    """The same weights in the reference layouts the port takes."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (
        t(p["dwconv"]["w"].transpose(3, 2, 0, 1)), t(p["dwconv"]["b"]),
        t(p["norm"]["scale"]), t(p["norm"]["bias"]),
        t(p["pwconv1"]["w"].T), t(p["pwconv1"]["b"]),
        t(p["pwconv2"]["w"].T), t(p["pwconv2"]["b"]),
        t(p["gamma"]) if "gamma" in p else None,
    )


def _jax_kernel(x_nhwc, p, dtype, ht, mrows):
    """JAX fused kernel (interpret mode on the CPU) on the HWBC-padded
    transpose of x; returns NHWC f32."""
    b, h, w, c = x_nhwc.shape
    cp = -(-c // 128) * 128
    xh = jnp.pad(jnp.asarray(x_nhwc.transpose(1, 2, 0, 3)), ((0, 0),) * 3 + ((0, cp - c),))
    y = fused_block_hwbc(
        xh.astype(dtype), p["dwconv"]["w"].reshape(K, K, c), p["dwconv"]["b"],
        p["norm"]["scale"], p["norm"]["bias"], p["pwconv1"]["w"], p["pwconv1"]["b"],
        p["pwconv2"]["w"], p["pwconv2"]["b"], p.get("gamma"), eps=1e-6, ht=ht, mrows=mrows)
    return np.asarray(y[..., :c].astype(jnp.float32)).transpose(2, 0, 1, 3)


@pytest.mark.parametrize(
    "shape,with_gamma,ht,mrows",
    [
        ((16, 13, 14, 96), True, 2, 2),   # C-padded on the TPU side, ragged H
        ((16, 31, 7, 128), False, 4, 1),  # stage-4 geometry of a 10-s clip, no gamma
    ],
)
def test_plain_version_matches_jax_kernel_f32(rng, shape, with_gamma, ht, mrows):
    b, h, w, c = shape
    p = _params(rng, c, with_gamma)
    x = (rng.randn(*shape) * 0.5).astype(np.float32)
    ref = _jax_kernel(x, p, jnp.float32, ht, mrows)
    got = FB.fused_block(torch.from_numpy(x), *_torch_args(p))
    assert got.dtype == torch.float32 and got.shape == shape
    # atol of the JAX package's own kernel-vs-composed-math test
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5)


def test_plain_version_matches_unfused_jax_block(rng):
    """f32: same function as the JAX package's _block_apply with tanh GELU."""
    shape = (2, 13, 14, 96)
    p = _params(rng, shape[-1])
    x = (rng.randn(*shape) * 0.5).astype(np.float32)
    ref = np.asarray(_block_apply(jnp.asarray(x), p, 1e-6, 0.0, None, "xla_approx"))
    got = FB.fused_block(torch.from_numpy(x), *_torch_args(p)).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-5)


def test_plain_version_matches_jax_kernel_bf16(rng):
    """bf16 activations: both round d, LN output and GELU output to bf16 and
    the block output once. Products summed in another order can land a
    value on the other side of a bf16 rounding boundary, so: at least 99.9%
    of the outputs bit-equal (measured 99.98%), and the rest within 2^-6
    absolute, four bf16 ulps at the output's scale |y| ~ 1 (measured one).
    The same block in f32 without the bf16 rounding points is bit-equal on
    only ~93% and off by up to 0.0073."""
    shape = (16, 13, 14, 96)
    p = _params(rng, shape[-1])
    x = (rng.randn(*shape) * 0.5).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = _jax_kernel(xb.float().numpy(), p, jnp.bfloat16, 2, 2)
    got = FB.fused_block(xb, *_torch_args(p))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref)
    assert err.max() <= 2.0**-6, err.max()
    assert np.mean(err == 0) >= 0.999, np.mean(err == 0)


def test_cpu_wrapper_is_the_plain_version(rng):
    shape = (2, 5, 7, 24)
    p = _params(rng, shape[-1])
    x = torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32))
    before = FB.fused_block.launches
    got = FB.fused_block(x, *_torch_args(p), 1e-6)
    assert torch.equal(got, FB.fused_block_reference(x, *_torch_args(p), 1e-6))
    assert FB.fused_block.launches == before  # no kernel launched on the CPU


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    p = _params(rng, 8)
    args = _torch_args(p)
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(TypeError):
        FB.fused_block(x.double(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        FB.fused_block(x.permute(0, 2, 1, 3), *args)
    with pytest.raises(ValueError, match="w1"):
        FB.fused_block(x, *args[:4], args[4][:, :4], *args[5:])
    with pytest.raises(ValueError, match="C <="):
        big = _torch_args(_params(rng, FB.MAX_C + 1, with_gamma=False))
        FB.fused_block(torch.zeros(1, 1, 1, FB.MAX_C + 1), *big)
    # neither CPU nor CUDA: no silent fallback to the plain version
    with pytest.raises(ValueError, match="cuda or cpu"):
        FB.fused_block(x.to("meta"), *(a.to("meta") if a is not None else None for a in args))


def _port_block(args, c):
    """A port Block module holding the weights of ``_torch_args``."""
    blk = Block(c, 1e-6, 1.0 if args[-1] is not None else 0.0)
    dst = (blk.dwconv.weight, blk.dwconv.bias, blk.norm.weight, blk.norm.bias,
           blk.pwconv1.weight, blk.pwconv1.bias, blk.pwconv2.weight, blk.pwconv2.bias, blk.gamma)
    with torch.no_grad():
        for t, d in zip(args, dst):
            if d is not None:
                d.copy_(t)
    return blk


def _bf16_input(rng, shape, layout):
    """bf16 NHWC x, contiguous or in the channels-first memory the stem and
    the downsamples leave behind (a permuted NCHW tensor)."""
    x = torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32)).to(torch.bfloat16)
    if layout == "nchw":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        assert not x.is_contiguous()
    return x


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("with_gamma", [True, False])
@pytest.mark.parametrize("shape", [(2, 13, 11, 96), (2, 7, 9, 192)],
                         ids=["stage1-width", "stage2-width"])
def test_unfused_rounding_mode_is_the_unfused_block_bit_for_bit(rng, shape, with_gamma, layout):
    """K1's unfused-rounding mode on the CPU is the port's unfused block
    (``_block_apply`` with tanh GELU) bit for bit, at stage-1 and stage-2
    widths, ragged H and W, with and without gamma, on x as the model hands
    it over: its layout is kept, so every op sees what it saw unfused."""
    c = shape[-1]
    args = _torch_args(_params(rng, c, with_gamma))
    x = _bf16_input(rng, shape, layout)
    before = (FB.fused_block.launches, FB.fused_block.unfused_rounding_launches)
    got = FB.fused_block(x, *args, 1e-6, unfused_rounding=True)
    want = port_block_apply(x, _port_block(args, c), "xla_approx")
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert got.stride() == want.stride()
    assert (FB.fused_block.launches, FB.fused_block.unfused_rounding_launches) == before
    # a different function from K1's own rounding: its outputs part on some elements
    own = FB.fused_block(x.contiguous(), *args, 1e-6)
    assert not torch.equal(own, got)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_unfused_rounding_mode_passes_opcheck(rng, layout):
    """The mode is a trailing argument of the same custom op (one node per
    block); its schema, fake implementation (the layout of x on the CPU)
    and tracing pass ``opcheck``."""
    args = _torch_args(_params(rng, 32))
    x = _bf16_input(rng, (2, 5, 6, 32), layout)
    torch.library.opcheck(FB._serving_op, (x, *args, 1e-6, True))
    assert "bool unfused_rounding=False" in str(FB._serving_op._opoverload._schema)


def test_unfused_rounding_mode_is_bf16_serving_only(rng):
    """The unfused-rounding mode takes bf16 alone; any layout of x in
    serving, but its save mode (the bf16 training step's) takes x
    contiguous, as K2 reads it, and C up to UNFUSED_SAVE_MAX_C."""
    args = _torch_args(_params(rng, 16))
    x = torch.zeros(1, 4, 4, 16)
    with pytest.raises(TypeError, match="bfloat16"):
        FB.fused_block(x, *args, unfused_rounding=True)
    with pytest.raises(TypeError, match="bfloat16"):
        FB.fused_block(x, *args, s=torch.ones(1), save_dwconv=True, unfused_rounding=True)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        FB.fused_block(xb.permute(0, 2, 1, 3), *args, s=torch.ones(1), unfused_rounding=True)
    with pytest.raises(ValueError, match="contiguous"):
        FB.fused_block(xb.permute(0, 2, 1, 3), *args, save_dwconv=True, unfused_rounding=True)
    with pytest.raises(ValueError, match="contiguous"):  # K1's own mode keeps its contract
        FB.fused_block(xb.permute(0, 2, 1, 3), *args)
    c = FB.UNFUSED_SAVE_MAX_C + 1
    assert FB.unfused_save_fits(FB.UNFUSED_SAVE_MAX_C) and not FB.unfused_save_fits(c)
    wide = _torch_args(_params(rng, c))
    with pytest.raises(ValueError, match=f"C <= {FB.UNFUSED_SAVE_MAX_C}"):
        FB.fused_block(torch.zeros(1, 2, 2, c, dtype=torch.bfloat16), *wide, save_dwconv=True,
                       unfused_rounding=True)


def _drop_scale(kind, b):
    """A block's drop-path draw: None, ones, or keep / keep_prob with a
    dropped sample (1 / 0.9 is not a bf16 value: the block takes it in bf16)."""
    if kind == "none":
        return None
    s = torch.ones(b)
    if kind == "draw":
        s = torch.tensor([0.0] + [1 / 0.9] * (b - 1))
    return s


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("scale", ["ones", "draw", "none"])
@pytest.mark.parametrize("shape", [(2, 13, 11, 96), (3, 7, 9, 192)],
                         ids=["stage1-width", "stage2-width"])
def test_unfused_rounding_save_mode_is_the_unfused_block_bit_for_bit(rng, shape, scale, layout):
    """K1's save mode in the unfused-rounding mode on the CPU, on x made
    contiguous as the training route hands it over: y is ``convnext_block``
    with the drop-path draw on x as the model holds it (either layout), bit
    for bit, and the save is d as the LN reads it (the depthwise sum
    rounded, then with its bias, rounded again) stacked with z (the second
    product plus its bias, rounded: what gamma multiplies)."""
    from audioset_convnext_inf_torch.ops.nhwc import conv2d, convnext_block

    c = shape[-1]
    args = _torch_args(_params(rng, c))
    x = _bf16_input(rng, shape, layout)
    s = _drop_scale(scale, shape[0])
    before = (FB.fused_block.launches, FB.fused_block.save_launches,
              FB.fused_block.unfused_rounding_save_launches)
    y, dz = FB.fused_block(x.contiguous(), *args, 1e-6, s=s, save_dwconv=True,
                           unfused_rounding=True)
    want, d, z = convnext_block(x, *args, 1e-6, "tanh", s, saves=True)
    assert y.dtype == dz.dtype == torch.bfloat16 and y.is_contiguous() and dz.is_contiguous()
    assert torch.equal(y, want) and dz.shape == (2, *shape)
    assert torch.equal(dz[0], d) and torch.equal(dz[1], z)
    dwc = F.conv2d(x.permute(0, 3, 1, 2), args[0].to(torch.bfloat16), None, padding=3, groups=c)
    assert torch.equal(dz[0], (dwc.permute(0, 2, 3, 1) + args[1]).to(torch.bfloat16))
    assert torch.equal(d, conv2d(x, args[0], args[1], padding=(3, 3), groups=c))
    if s is None:  # no draw: the scale of ones
        y1 = FB.fused_block(x.contiguous(), *args, 1e-6, s=torch.ones(shape[0]),
                            unfused_rounding=True)
        assert torch.equal(y1, y)
    assert (FB.fused_block.launches, FB.fused_block.save_launches,
            FB.fused_block.unfused_rounding_save_launches) == before


def test_unfused_rounding_save_mode_passes_opcheck(rng):
    """The save op's trailing flag: schema, fake implementation (the
    (2, B, H, W, C) save) and tracing pass ``opcheck``; unset, the op is
    K1's own save mode."""
    args = _torch_args(_params(rng, 32))
    x = _bf16_input(rng, (2, 5, 6, 32), "nhwc")
    s = torch.tensor([0.0, 1 / 0.9])
    torch.library.opcheck(FB._save_op, (x, *args, 1e-6, s, True))
    torch.library.opcheck(FB._save_op, (x, *args, 1e-6, s))
    assert "bool unfused_rounding=False" in str(FB._save_op._opoverload._schema)
    own = FB._save_op(x, *args, 1e-6, s)
    assert all(torch.equal(a, b) for a, b in zip(own, FB.fused_block_reference(
        x, *args, 1e-6, s, True)))
