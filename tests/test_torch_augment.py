"""The port's waveform augmentations (``ops/augment.py``: crop, pad,
pad_or_truncate, the resamplers) against the JAX package's.

Tolerances: crop, pad, pad_or_truncate, the nearest-index resample and its
indices are bit-equal given the same offsets (JAX's ``align="random"``
offsets are drawn from its key here and handed to the port's op);
``sinc_resample_kernel``'s banks are equal; ``resample_linear`` is within
1e-6 of the JAX package's (both work in f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioset_convnext_inf_tpu.ops import augment as JA

from audioset_convnext_inf_torch.ops import augment as A


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("align", ["left", "right", "center", "random"])
@pytest.mark.parametrize("length,target", [(1000, 640), (1000, 999), (640, 1000), (1000, 1000)])
def test_crop_and_pad_bit_equal(align, length, target):
    x = _x((3, length), seed=length + target)
    key = jax.random.PRNGKey(length * 7 + target)
    diff, missing = length - target, target - length
    start = int(jax.random.randint(key, (), 0, diff)) if align == "random" and diff > 0 else None
    left = (int(jax.random.randint(key, (), 0, missing + 1))
            if align == "random" and missing > 0 else None)
    got = A.crop(torch.from_numpy(x), target, align, start=start).numpy()
    want = np.asarray(JA.crop(jnp.asarray(x), target, align, key=key))
    np.testing.assert_array_equal(got, want)
    for fill in (0.0, -0.25):
        got = A.pad(torch.from_numpy(x), target, align, fill_value=fill, left=left).numpy()
        want = np.asarray(JA.pad(jnp.asarray(x), target, align, fill_value=fill, key=key))
        np.testing.assert_array_equal(got, want)
    got = A.pad_or_truncate(torch.from_numpy(x[0]), target).numpy()
    np.testing.assert_array_equal(got, np.asarray(JA.pad_or_truncate(jnp.asarray(x[0]), target)))


def test_random_alignment_takes_a_draw():
    x = torch.zeros(2, 100)
    with pytest.raises(ValueError, match="draw_crop_start"):
        A.crop(x, 50, "random")
    with pytest.raises(ValueError, match="draw_pad_left"):
        A.pad(x, 150, "random")
    with pytest.raises(ValueError, match="outside"):
        A.crop(x, 50, "random", start=50)
    with pytest.raises(ValueError, match="unknown align"):
        A.pad(x, 150, "middle")
    g = torch.Generator().manual_seed(0)
    starts = {A.draw_crop_start(g, 100, 90) for _ in range(200)}
    lefts = {A.draw_pad_left(g, 90, 100) for _ in range(200)}
    assert starts == set(range(10)) and lefts == set(range(11))
    assert A.draw_crop_start(g, 80, 90) == 0
    a = [A.draw_pad_left(torch.Generator().manual_seed(5), 10, 99) for _ in range(2)]
    assert a[0] == a[1]


@pytest.mark.parametrize("rate", [0.5, 0.9, 1.1, 1.5, 2.0])
def test_nearest_resample_bit_equal(rate):
    x = _x((2, 1234), seed=int(rate * 10))
    got = A.resample(torch.from_numpy(x), rate, "nearest").numpy()
    want = JA.resample(x, rate, "nearest")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    idx = A.resample_nearest_indices(1234, rate, 900, device="cpu")
    jidx = JA.resample_nearest_indices(1234, jnp.float32(rate), 900)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    on_rate = A.resample_nearest_indices(1234, torch.tensor(rate), 900)
    np.testing.assert_array_equal(on_rate.numpy(), idx.numpy())


@pytest.mark.parametrize("rate,quantize_hz", [(0.9, None), (1.1, None), (1.5, None),
                                              (0.9, 100), (1.1, 100), (1.5, 100),
                                              (1.0137, 100), (0.73, None)])
def test_linear_resample_within_1e6(rate, quantize_hz):
    x = _x((2, 4000), seed=int(rate * 1000))
    got = A.resample_linear(torch.from_numpy(x), rate, quantize_hz=quantize_hz)
    want = JA.resample_linear(x, rate, quantize_hz=quantize_hz)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    one = A.resample_linear(torch.from_numpy(x[1]), rate, quantize_hz=quantize_hz)
    np.testing.assert_allclose(one.numpy(), want[1], rtol=0, atol=1e-6)
    if quantize_hz is None:
        np.testing.assert_allclose(A.resample(torch.from_numpy(x), rate, "linear").numpy(), want,
                                   rtol=0, atol=1e-6)


def test_sinc_banks_equal_and_only_small_ones_cached():
    for orig, new in [(10, 9), (10, 11), (320, 441), (2, 3)]:
        k, w = A.sinc_resample_kernel(orig, new)
        jk, jw = JA.sinc_resample_kernel(orig, new)
        assert w == jw and k.dtype == torch.float32
        np.testing.assert_array_equal(k.numpy(), jk)
    assert A._cacheable_bank(10, 11, 6, 0.99)
    assert not A._cacheable_bank(32000, 32437, 6, 0.99)  # a near-coprime drawn rate: 4 GB
    assert not A._cacheable_bank(1600, 1601, 6, 0.99)  # 2.6M elements
    A.sinc_resample_kernel.cache_clear()
    x = torch.from_numpy(_x((1, 800)))
    A.resample_linear(x, 1.1, quantize_hz=100)
    assert A.sinc_resample_kernel.cache_info().currsize == 1
    y = A.resample_linear(x, 1.0007, sample_rate=1600)  # 1600 -> 1601 Hz: built for the call
    assert A.sinc_resample_kernel.cache_info().currsize == 1 and y.shape == (1, 801)
    with pytest.raises(ValueError, match="interpolation"):
        A.resample(x, 1.1, "cubic")
