"""Seeded weights of Wavegram-Logmel-CNN14 in the published state-dict
layout, made on the device.

``make_state_dict`` draws every parameter and BatchNorm statistic from one
seed in two large calls on the device (one normal and one uniform draw),
then cuts and shapes them per leaf, in the port's state-dict order (the
published keys, without ``num_batches_tracked``). So that every layer
reaches the answer and no BatchNorm is the identity:

 - convolution and linear weights He-normal, N(0, 2 / fan_in), truncated
   at two standard deviations, and linear biases N(0, 0.1^2), so that a
   map keeps its scale through each convolution and ReLU;
 - every BatchNorm: scale U(0.5, 1.5), shift N(0, 0.1^2), running mean
   N(0, 0.1^2), running variance U(0.5, 2);
 - except the two that meet the input, whose statistics are drawn about
   the level of the benchmark's clips (``benchmark/clips.py``, about 0.035
   RMS): bn0 over the log-mel's bins, running mean -30 + N(0, 5^2) dB and
   variance U(100, 200) dB^2, shift N(0, 0.5^2); ``pre_bn0`` after the
   first Wavegram convolution, running mean N(0, 0.01^2) and variance
   U(0.001, 0.004).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str]


def _bn(key: str, n: int, prefix: str = "") -> List[Leaf]:
    return [(f"{key}.weight", (n,), "bn_w"), (f"{key}.bias", (n,), prefix + "bn_b"),
            (f"{key}.running_mean", (n,), prefix + "bn_rm"),
            (f"{key}.running_var", (n,), prefix + "bn_rv")]


def _block(key: str, cin: int, cout: int, kernel: Tuple[int, ...]) -> List[Leaf]:
    """A ConvBlock or ConvPreWavBlock: conv1, conv2, bn1, bn2."""
    return ([(f"{key}.conv1.weight", (cout, cin) + kernel, "w"),
             (f"{key}.conv2.weight", (cout, cout) + kernel, "w")]
            + _bn(f"{key}.bn1", cout) + _bn(f"{key}.bn2", cout))


def param_table(mcfg: dict) -> List[Leaf]:
    """(key, shape, kind) of every entry of the state dict, in order."""
    w = mcfg["wavegram_channels"]  # 64, 64, 128, 128
    c = mcfg["channels"]  # 64 ... 2048
    g = mcfg["wavegram_groups"]
    out: List[Leaf] = [("pre_conv0.weight", (w[0], 1, mcfg["pre_conv0_kernel"]), "w")]
    out += _bn("pre_bn0", w[0], "wave_")
    for i in range(1, 4):
        out += _block(f"pre_block{i}", w[i - 1], w[i], (3,))
    out += _block("pre_block4", w[3] // g, c[0], (3, 3))
    out += _bn("bn0", mcfg["frontend"]["n_mels"], "mel_")
    out += _block("conv_block1", 1, c[0], (3, 3))
    out += _block("conv_block2", 2 * c[0], c[1], (3, 3))
    for i in range(3, 7):
        out += _block(f"conv_block{i}", c[i - 2], c[i - 1], (3, 3))
    out += [("fc1.weight", (c[-1], c[-1]), "w"), ("fc1.bias", (c[-1],), "b"),
            ("fc_audioset.weight", (mcfg["num_classes"], c[-1]), "w"),
            ("fc_audioset.bias", (mcfg["num_classes"],), "b")]
    return out


_UNIFORM = {"bn_w": (0.5, 1.0), "bn_rv": (0.5, 1.5), "mel_bn_rv": (100.0, 100.0),
            "wave_bn_rv": (0.001, 0.003)}  # (low, width)
_NORMAL = {"w": (0.0, None), "b": (0.0, 0.1), "bn_b": (0.0, 0.1), "bn_rm": (0.0, 0.1),
           "mel_bn_b": (0.0, 0.5), "mel_bn_rm": (-30.0, 5.0), "wave_bn_b": (0.0, 0.1),
           "wave_bn_rm": (0.0, 0.01)}  # (mean, std); None: He, sqrt(2 / fan_in)


def make_state_dict(mcfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every entry of the state dict in float32 on ``device``, from ``seed``."""
    device = torch.device(device)
    table = param_table(mcfg)
    sizes = [math.prod(shape) for _, shape, _ in table]
    n_norm = sum(s for s, (_, _, kind) in zip(sizes, table) if kind in _NORMAL)
    n_unif = sum(s for s, (_, _, kind) in zip(sizes, table) if kind in _UNIFORM)
    g = torch.Generator(device=device).manual_seed(seed % 2**64)
    normal = torch.randn(n_norm, generator=g, device=device)
    uniform = torch.rand(n_unif, generator=g, device=device)
    sd, on, ou = {}, 0, 0
    for (key, shape, kind), n in zip(table, sizes):
        if kind in _NORMAL:
            z = normal[on:on + n]
            on += n
            mean, std = _NORMAL[kind]
            if std is None:
                z, std = z.clamp(-2.0, 2.0), math.sqrt(2.0 / math.prod(shape[1:]))
            v = z * std + mean
        else:
            u = uniform[ou:ou + n]
            ou += n
            low, width = _UNIFORM[kind]
            v = u * width + low
        sd[key] = v.reshape(shape).clone()
    return sd
