"""The port's fused block backward (K2), the forward's save mode (K1) and the
trainable fused block, against the JAX package.

On the CPU the wrappers run their kernels' plain versions. In f32 these are
held against ``jax.vjp`` of the JAX package's XLA block (``_block_apply``
with the tanh GELU and drop path), whose gradients are the ground truth of
the fused backward; in bf16, one case each is held against the JAX
package's Pallas kernels in interpret mode (as its own tests run them), at
the smallest shape they take, which holds the rounding points; the
unfused-rounding mode, which rounds where the XLA block rounds in bf16, is
held against ``jax.vjp`` of that block in bf16. The CUDA
kernels are compared with the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioset_convnext_inf_tpu.models import layers as JL
from audioset_convnext_inf_tpu.models.convnext import _block_apply
from audioset_convnext_inf_tpu.ops.pallas_fused_block import fused_block_hwbc
from audioset_convnext_inf_tpu.ops.pallas_fused_block_bwd import fused_block_bwd_hwbc

from audioset_convnext_inf_torch.ops import fused_block as FB
from audioset_convnext_inf_torch.ops import fused_block_bwd as FBB
from audioset_convnext_inf_torch.ops.fused_block_train import FusedBlockTrain
from audioset_convnext_inf_torch.ops.nhwc import convnext_block

K = 7
EPS = 1e-6
NAMES = ("dwconv.weight", "dwconv.bias", "norm.weight", "norm.bias", "pwconv1.weight",
         "pwconv1.bias", "pwconv2.weight", "pwconv2.bias", "gamma")


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


def _params(rng, c):
    """Block weights in the JAX package's layouts, of order-1 effect."""
    p = {
        "dwconv": {"w": rng.randn(K, K, 1, c) * 0.1, "b": rng.randn(c) * 0.1},
        "norm": {"scale": 1 + rng.randn(c) * 0.1, "bias": rng.randn(c) * 0.1},
        "pwconv1": {"w": rng.randn(c, 4 * c) * c ** -0.5, "b": rng.randn(4 * c) * 0.1},
        "pwconv2": {"w": rng.randn(4 * c, c) * (4 * c) ** -0.5, "b": rng.randn(c) * 0.1},
        "gamma": 0.5 + 0.1 * rng.randn(c),
    }
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_args(p):
    """(dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma) in the port's layouts."""
    return (_t(p["dwconv"]["w"].transpose(3, 2, 0, 1)), _t(p["dwconv"]["b"]),
            _t(p["norm"]["scale"]), _t(p["norm"]["bias"]),
            _t(p["pwconv1"]["w"].T), _t(p["pwconv1"]["b"]),
            _t(p["pwconv2"]["w"].T), _t(p["pwconv2"]["b"]), _t(p["gamma"]))


def _bwd_args(args):
    """The backward's weights: the forward's without the dwconv bias."""
    return (args[0],) + tuple(args[2:])


def _jax_grads_as_port(g):
    """JAX gradient pytree of one block -> {port parameter name: array}."""
    return {
        "dwconv.weight": np.asarray(g["dwconv"]["w"]).transpose(3, 2, 0, 1),
        "dwconv.bias": g["dwconv"]["b"], "norm.weight": g["norm"]["scale"],
        "norm.bias": g["norm"]["bias"], "pwconv1.weight": np.asarray(g["pwconv1"]["w"]).T,
        "pwconv1.bias": g["pwconv1"]["b"], "pwconv2.weight": np.asarray(g["pwconv2"]["w"]).T,
        "pwconv2.bias": g["pwconv2"]["b"], "gamma": g["gamma"],
    }


def _drop_path_case(b, drop=0.4, seed=3):
    """A key for the JAX block's drop path and the same draw as the port's
    per-sample scale s (keep / keep_prob); some samples are dropped."""
    key = jax.random.PRNGKey(seed)
    keep = np.asarray(jax.random.bernoulli(key, 1 - drop, (b, 1, 1, 1)), np.float32).reshape(-1)
    assert 0 < keep.sum() < b
    return key, drop, _t(keep) / np.float32(1 - drop)


def _assert_close(got, ref, tol, name):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{name}: max_abs_err {err:.3e} > {tol:.1e} * {scale:.3f}"


def test_save_mode_plain_version_matches_jax_block_f32(rng):
    """f32: y is the JAX package's XLA block with its drop path, d its
    dwconv (plus bias), within 3e-5, the JAX package's own kernel-vs-math
    tolerance."""
    b, h, w, c = 4, 7, 5, 64
    p = _params(rng, c)
    x = (rng.randn(b, h, w, c) * 0.5).astype(np.float32)
    key, drop, s = _drop_path_case(b)
    y_ref, d_ref = jax.jit(lambda x, p: (
        _block_apply(x, p, EPS, drop, key, "xla_approx"),
        JL.conv2d(x, p["dwconv"]["w"], p["dwconv"]["b"], padding=(3, 3), feature_group_count=c),
    ))(jnp.asarray(x), p)
    y, d = FB.fused_block(_t(x), *_torch_args(p), EPS, s=s, save_dwconv=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=3e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=3e-5)
    # without s and d the save mode is the serving block, bit for bit
    ones = torch.ones(b)
    y1, _ = FB.fused_block(_t(x), *_torch_args(p), EPS, s=ones, save_dwconv=True)
    assert torch.equal(y1, FB.fused_block(_t(x), *_torch_args(p), EPS))


def _hwbc(a_nhwc, cp):
    a = jnp.asarray(np.asarray(a_nhwc.float().numpy()).transpose(1, 2, 0, 3))
    return jnp.pad(a, ((0, 0),) * 3 + ((0, cp - a.shape[-1]),))


def _nhwc(a_hwbc, c):
    return np.asarray(a_hwbc[..., :c].astype(jnp.float32)).transpose(2, 0, 1, 3)


# the smallest geometry the JAX kernels take: B=16 (one sublane group),
# C=64 padded to 128 lanes, H=6 in two tiles of ht=3 (the backward's
# minimum), W=3
SMALL = (16, 6, 3, 64)


def test_save_mode_plain_version_matches_jax_kernel_bf16(rng):
    """bf16, against the JAX kernel's save mode in interpret mode, with
    dropped samples: y and d round at the same points, so at least 99.9%
    are bit-equal and the rest within 2^-6 of scale (PR 1's K1 bounds)."""
    b, h, w, c = SMALL
    p = _params(rng, c)
    x = _t(rng.randn(b, h, w, c) * 0.5).float().to(torch.bfloat16)
    _, _, s = _drop_path_case(b)
    y_ref, d_ref = fused_block_hwbc(
        _hwbc(x, 128).astype(jnp.bfloat16), p["dwconv"]["w"].reshape(K, K, c), p["dwconv"]["b"],
        p["norm"]["scale"], p["norm"]["bias"], p["pwconv1"]["w"], p["pwconv1"]["b"],
        p["pwconv2"]["w"], p["pwconv2"]["b"], p["gamma"], eps=EPS, ht=3,
        save_dwconv=True, s=jnp.asarray(s.numpy()))
    y, d = FB.fused_block(x, *_torch_args(p), EPS, s=s, save_dwconv=True)
    assert y.dtype == d.dtype == torch.bfloat16
    for name, got, ref in (("y", y, y_ref), ("d", d, d_ref)):
        err = np.abs(got.float().numpy() - _nhwc(ref, c))
        assert err.max() <= 2.0 ** -6 * max(1.0, np.abs(_nhwc(ref, c)).max()), (name, err.max())
        assert np.mean(err == 0) >= 0.999, (name, np.mean(err == 0))


@pytest.mark.parametrize("shape", [
    (4, 7, 5, 64),
    (2, 6, 3, 100),   # C not a multiple of 128 (nor of 4)
    (3, 11, 4, 48),   # an H the JAX backward tiles raggedly (ht=4: 4+4+3)
])
def test_bwd_plain_version_matches_jax_vjp_f32(rng, shape):
    """f32: dx and all nine weight gradients against jax.vjp of the JAX
    package's XLA block with drop path, within 2e-4 of scale (the JAX
    package's fused-backward tolerance)."""
    b, h, w, c = shape
    p = _params(rng, c)
    x = (rng.randn(*shape) * 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    key, drop, s = _drop_path_case(b)
    # jitted: one XLA compile is far cheaper than op-by-op dispatch here
    dx_ref, g_ref = jax.jit(lambda x, p, dy: jax.vjp(
        lambda x, p: _block_apply(x, p, EPS, drop, key, "xla_approx"), x, p)[1](dy))(
            jnp.asarray(x), p, jnp.asarray(dy))
    args = _torch_args(p)
    _, d = FB.fused_block(_t(x), *args, EPS, s=s, save_dwconv=True)
    dx, g = FBB.fused_block_bwd(_t(x), d, _t(dy), *_bwd_args(args), s, EPS)
    assert set(g) == set(NAMES)
    _assert_close(dx, dx_ref, 2e-4, "dx")
    for name, ref in _jax_grads_as_port(g_ref).items():
        assert g[name].dtype == torch.float32 and tuple(g[name].shape) == np.shape(ref), name
        _assert_close(g[name], ref, 2e-4, name)


def test_bwd_plain_version_matches_jax_kernel_bf16(rng):
    """bf16, against the JAX backward kernel in interpret mode on the same
    x, d, dy and s: the same rounding points (xn, gact, dy*s, dz2, dh1, dd,
    dx; dgamma from W2 rounded to bf16), so dx and each gradient within
    2^-6 of scale; sums in other orders flip single bf16 roundings."""
    b, h, w, c = SMALL
    p = _params(rng, c)
    args = _torch_args(p)
    x = _t(rng.randn(b, h, w, c) * 0.5).float().to(torch.bfloat16)
    dy = _t(rng.randn(b, h, w, c)).float().to(torch.bfloat16)
    _, _, s = _drop_path_case(b)
    _, d = FB.fused_block(x, *args, EPS, s=s, save_dwconv=True)
    dx_ref, g_ref = fused_block_bwd_hwbc(
        _hwbc(x, 128).astype(jnp.bfloat16), _hwbc(d, 128).astype(jnp.bfloat16),
        _hwbc(dy, 128).astype(jnp.bfloat16), p["dwconv"]["w"].reshape(K, K, c),
        p["norm"]["scale"], p["norm"]["bias"], p["pwconv1"]["w"], p["pwconv1"]["b"],
        p["pwconv2"]["w"], p["pwconv2"]["b"], p["gamma"], jnp.asarray(s.numpy()),
        eps=EPS, ht=3)
    g_ref = dict(g_ref, dwconv=dict(g_ref["dwconv"], w=g_ref["dwconv"]["w"].reshape(K, K, 1, c)))
    dx, g = FBB.fused_block_bwd(x, d, dy, *_bwd_args(args), s, EPS)
    assert dx.dtype == torch.bfloat16
    _assert_close(dx.float(), _nhwc(dx_ref, c), 2.0 ** -6, "dx")
    for name, ref in _jax_grads_as_port(g_ref).items():
        _assert_close(g[name], ref, 2.0 ** -6, name)


def test_fused_block_train_matches_autograd_of_plain_version(rng):
    """FusedBlockTrain (save-mode forward, fused backward) against torch
    autograd through the plain forward, f32, within 1e-4 of scale; s and
    eps get no gradient, and the gradients keep the parameters' layouts."""
    b, h, w, c = 3, 6, 5, 24
    p = _params(rng, c)
    args = [a.requires_grad_() for a in _torch_args(p)]
    x = _t(rng.randn(b, h, w, c) * 0.5).float().requires_grad_()
    dy = _t(rng.randn(b, h, w, c)).float()
    s = torch.tensor([0.0, 1 / 0.7, 1 / 0.7])
    y = FusedBlockTrain.apply(x, *args, s, EPS)
    got = torch.autograd.grad((y * dy).sum(), [x, *args])
    y_ref = FB.fused_block_reference(x, *args, EPS, s)
    ref = torch.autograd.grad((y_ref * dy).sum(), [x, *args])
    assert torch.equal(y, y_ref)
    for name, a, r in zip(("x",) + NAMES, got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        _assert_close(a, r, 1e-4, name)
    # no drop path: s=None is a scale of ones
    y0 = FusedBlockTrain.apply(x, *args, None, EPS)
    assert torch.equal(y0, FB.fused_block_reference(x, *args, EPS))


def test_bwd_cpu_wrapper_is_the_plain_version_and_checks_its_arguments(rng):
    b, h, w, c = 2, 5, 4, 16
    args = _bwd_args(_torch_args(_params(rng, c)))
    x, d, dy = (_t(rng.randn(b, h, w, c)).float() for _ in range(3))
    s = torch.ones(b)
    before = FBB.fused_block_bwd.launches
    dx, g = FBB.fused_block_bwd(x, d, dy, *args, s)
    dx_ref, g_ref = FBB.fused_block_bwd_reference(x, d, dy, *args, s)
    assert torch.equal(dx, dx_ref) and all(torch.equal(g[k], g_ref[k]) for k in NAMES)
    assert FBB.fused_block_bwd.launches == before  # no kernel launched on the CPU
    with pytest.raises(ValueError, match="gamma"):
        FBB.fused_block_bwd(x, d, dy, *args[:-1], None, s)
    with pytest.raises(ValueError, match="dy"):
        FBB.fused_block_bwd(x, d, dy[:, :-1].contiguous(), *args, s)
    with pytest.raises(ValueError, match="s has shape"):
        FBB.fused_block_bwd(x, d, dy, *args, torch.ones(b + 1))
    # neither CPU nor CUDA: no silent fallback to the plain version
    meta = [t.to("meta") for t in (x, d, dy, *args, s)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        FBB.fused_block_bwd(*meta)


def _unfused_case(rng, shape):
    """bf16 x and dy, the block's weights (port layouts) and a drop-path
    draw with a dropped sample (1 / 0.9 is not a bf16 value)."""
    b, c = shape[0], shape[-1]
    args = _torch_args(_params(rng, c))
    x = _t(rng.randn(*shape) * 0.5).float().to(torch.bfloat16)
    dy = _t(rng.randn(*shape)).float().to(torch.bfloat16)
    s = torch.tensor([0.0] + [1 / 0.9] * (b - 1))
    return x, dy, args, s


def _autograd_of_unfused_block(x, dy, args, s, dtype):
    """dx and the nine gradients (f32) of ``convnext_block`` with drop path,
    tanh GELU, its activations in ``dtype``."""
    xs = x.detach().to(dtype).requires_grad_()
    ps = [a.detach().clone().requires_grad_() for a in args]
    convnext_block(xs, *ps, EPS, "tanh", s).backward(dy.to(dtype))
    return [xs.grad.float()] + [p.grad.float() for p in ps]


@pytest.mark.parametrize("shape", [(2, 9, 7, 96), (3, 6, 5, 192)],
                         ids=["stage1-width", "stage2-width"])
def test_unfused_rounding_bwd_is_autograd_of_the_unfused_block(rng, shape):
    """The unfused-rounding mode's twin against autograd of the unfused
    block (``convnext_block``, bf16) on the same x, dy and draw: dx and
    each of the nine gradients within 2^-5 of scale (autograd rounds every
    op's gradient to bf16, the twin only dys, dz2, dh1, dd and dx: measured
    under 2^-7). Over the ten, its mean relative gap to autograd of the
    f32 block on the same inputs is no larger than bf16 autograd's: the
    rounding points of the configuration's precision and no more.
    FusedBlockTrain in that mode gives convnext_block's y and the twin's
    gradients, through both custom ops."""
    x, dy, args, s = _unfused_case(rng, shape)
    _, dz = FB.fused_block(x, *args, EPS, s=s, save_dwconv=True, unfused_rounding=True)
    dx, g = FBB.fused_block_bwd(x, dz, dy, *_bwd_args(args), s, EPS, True)
    twin = [dx.float()] + [g[k] for k in NAMES]
    bf16 = _autograd_of_unfused_block(x, dy, args, s, torch.bfloat16)
    f32 = _autograd_of_unfused_block(x, dy, args, s, torch.float32)
    for name, a, r in zip(("x",) + NAMES, twin, bf16):
        assert a.shape == r.shape, name
        _assert_close(a, r, 2.0 ** -5, name)

    def rel(a, r):
        return float((a - r).norm() / r.norm())

    gaps = [rel(a, r) for a, r in zip(twin, f32)]
    autograd_gaps = [rel(a, r) for a, r in zip(bf16, f32)]
    assert np.mean(gaps) <= np.mean(autograd_gaps), (gaps, autograd_gaps)
    xs = x.detach().requires_grad_()
    ps = [a.detach().clone().requires_grad_() for a in args]
    y = FusedBlockTrain.apply(xs, *ps, s, EPS, True)
    y.backward(dy)
    assert torch.equal(y, convnext_block(x, *args, EPS, "tanh", s))
    assert torch.equal(xs.grad, dx)
    for name, p in zip(NAMES, ps):
        assert p.grad.dtype == torch.float32 and torch.equal(p.grad, g[name]), name


def _jax_block_and_vjp(x, dy, p, key, drop, dtype):
    """y and (dx and the nine gradients, port layouts) of ``jax.vjp`` of
    the JAX package's XLA block (tanh GELU, drop path under ``key``), its
    activations in ``dtype``, all as f32 arrays."""
    def f(x, p, dy):
        y, vjp = jax.vjp(lambda x, p: _block_apply(x, p, EPS, drop, key, "xla_approx"), x, p)
        return y, vjp(dy)

    xj, dyj = (jnp.asarray(a.float().numpy()).astype(dtype) for a in (x, dy))
    y, (dx, g) = jax.jit(f)(xj, p, dyj)
    g = _jax_grads_as_port(g)
    as32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    return as32(y), [as32(dx)] + [as32(g[k]) for k in NAMES]


@pytest.mark.parametrize("shape,seed", [((4, 9, 7, 96), 9), ((3, 6, 5, 192), 6)],
                         ids=["stage1-width", "stage2-width"])
def test_unfused_rounding_block_is_jax_vjp_of_the_bf16_block(rng, shape, seed):
    """FusedBlockTrain in the unfused-rounding mode (the save op's forward,
    the backward op's twin) against ``jax.vjp`` of the JAX package's XLA
    block in bf16, on the same x, dy and drop-path draw (a dropped sample
    and kept ones). The two round at the same points but one: ATen's tanh
    GELU rounds once, the JAX package's rounds each step of its bf16
    expression, and 40% of the hidden units differ by an ulp. So y within
    2^-6 of scale (K1's bf16 bound; measured under 1.0e-2), a dropped sample's y
    its x bit for bit, and dx and each of the nine gradients within 2^-5 of
    scale (as against the port's own bf16 autograd; measured under 2^-6 but
    dgamma at the stage-1 width, 2.7e-2: the JAX block's own bf16 error,
    2.9e-2 from the f32 block against the port's 6.5e-3). Against the f32
    block's jax.vjp on the same inputs, y and the ten gradients on the mean
    are no farther than the JAX package's own bf16 block."""
    key, drop, s = _drop_path_case(shape[0], seed=seed)
    p = _params(rng, shape[-1])
    args = _torch_args(p)
    x = _t(rng.randn(*shape) * 0.5).float().to(torch.bfloat16)
    dy = _t(rng.randn(*shape)).float().to(torch.bfloat16)
    xs = x.detach().requires_grad_()
    ps = [a.detach().clone().requires_grad_() for a in args]
    y = FusedBlockTrain.apply(xs, *ps, s, EPS, True)
    y.backward(dy)
    port = [xs.grad.float().numpy()] + [q.grad.numpy() for q in ps]
    y_bf16, bf16 = _jax_block_and_vjp(x, dy, p, key, drop, jnp.bfloat16)
    y_f32, f32 = _jax_block_and_vjp(x, dy, p, key, drop, jnp.float32)
    y = y.detach().float().numpy()
    _assert_close(y, y_bf16, 2.0 ** -6, "y")
    dropped = s.numpy() == 0
    assert dropped.any() and np.array_equal(y[dropped], x.float().numpy()[dropped])
    for name, a, r in zip(("x",) + NAMES, port, bf16):
        assert a.shape == r.shape, name
        _assert_close(a, r, 2.0 ** -5, name)

    def rel(a, r):
        return float(np.linalg.norm(a - r) / np.linalg.norm(r))

    assert rel(y, y_f32) <= rel(y_bf16, y_f32)
    gaps = [rel(a, r) for a, r in zip(port, f32)]
    jax_gaps = [rel(a, r) for a, r in zip(bf16, f32)]
    assert np.mean(gaps) <= np.mean(jax_gaps), (gaps, jax_gaps)


def test_unfused_rounding_bwd_differs_from_the_own_rounding_where_it_should(rng):
    """The mode's twin takes gamma, s and the taps in bf16 and dgamma from
    the saved z: on the same x, d and dy its dgamma is sum dy*s * z, and it
    differs from the fused-rounding backward's."""
    x, dy, args, s = _unfused_case(rng, (2, 5, 4, 96))
    _, dz = FB.fused_block(x, *args, EPS, s=s, save_dwconv=True, unfused_rounding=True)
    _, g = FBB.fused_block_bwd_reference(x, dz, dy, *_bwd_args(args), s, EPS, True)
    sb = s.to(torch.bfloat16).float().reshape(-1, 1, 1, 1)
    want = (dy.float() * sb * dz[1].float()).sum((0, 1, 2))
    torch.testing.assert_close(g["gamma"], want, rtol=1e-5, atol=1e-5)
    _, own = FBB.fused_block_bwd_reference(x, dz[0].contiguous(), dy, *_bwd_args(args), s, EPS)
    assert not torch.equal(own["gamma"], g["gamma"])


def test_unfused_rounding_bwd_passes_opcheck_and_checks_its_arguments(rng):
    """The backward op's trailing flag: schema, fake implementation and
    tracing pass ``opcheck``; the mode takes bf16 and the (2, B, H, W, C)
    save."""
    x, dy, args, s = _unfused_case(rng, (2, 5, 6, 32))
    _, dz = FB.fused_block(x, *args, EPS, s=s, save_dwconv=True, unfused_rounding=True)
    wts = _bwd_args(args)
    torch.library.opcheck(FBB._bwd_op, (x, dz, dy, *wts, s, EPS, True))
    assert "bool unfused_rounding=False" in str(FBB._bwd_op._opoverload._schema)
    before = (FBB.fused_block_bwd.launches, FBB.fused_block_bwd.unfused_rounding_launches)
    dx, g = FBB.fused_block_bwd(x, dz, dy, *wts, s, EPS, True)
    dx_ref, g_ref = FBB.fused_block_bwd_reference(x, dz, dy, *wts, s, EPS, True)
    assert torch.equal(dx, dx_ref) and all(torch.equal(g[k], g_ref[k]) for k in NAMES)
    assert (FBB.fused_block_bwd.launches, FBB.fused_block_bwd.unfused_rounding_launches) == before
    with pytest.raises(ValueError, match="d must be"):
        FBB.fused_block_bwd(x, dz[0].contiguous(), dy, *wts, s, EPS, True)
    with pytest.raises(TypeError, match="bfloat16"):
        FBB.fused_block_bwd(x.float(), dz.float(), dy.float(), *wts, s, EPS, True)
    with pytest.raises(TypeError, match="bfloat16"):
        FBB.launch_plan(32, torch.float32, 2, 5, 6, unfused_rounding=True)
    # the kernel's mode is the call's, and its plan must have been made for it
    for made_for in (False, True):
        plan = FBB.launch_plan(32, torch.bfloat16, 2, 5, 6, unfused_rounding=made_for)
        with pytest.raises(ValueError, match="plan made with"):
            FBB._backward_cuda(x, dz, dy, *wts, s, EPS, plan, unfused=not made_for)
