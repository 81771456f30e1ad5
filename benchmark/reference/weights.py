"""Seeded weights in the reference's state-dict layout, made on the device.

``make_state_dict`` draws every parameter and bn0 statistic of the audio
ConvNeXt from one seed in two large calls on the device (one normal and
one uniform draw), then cuts and shapes them per leaf. Conv and linear
weights and biases are N(0, 0.02^2) (weights truncated at two standard
deviations), LayerNorm scales 1 + N(0, 0.1^2) and shifts N(0, 0.1^2), the
layer scales gamma U(0.1, 1) (at their published init of 1e-6 every
block is nearly the identity and the check would see little of it), and
bn0 gets a scale U(0.5, 2), a shift N(0, 0.5^2), a running mean
-40 + N(0, 5^2) dB and a running variance U(50, 200) dB^2.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str]


def param_table(mcfg: dict) -> List[Leaf]:
    """(key, shape, kind) of every entry of the state dict, in order."""
    dims, depths = mcfg["dims"], mcfg["depths"]
    k, _, _ = _stem_kernel(mcfg["after_stem_dim"])
    m = mcfg["frontend"]["n_mels"]
    out: List[Leaf] = [("bn0.weight", (m,), "bn_w"), ("bn0.bias", (m,), "bn_b"),
                       ("bn0.running_mean", (m,), "bn_rm"), ("bn0.running_var", (m,), "bn_rv"),
                       ("downsample_layers.0.0.weight", (dims[0], 1) + tuple(k), "w"),
                       ("downsample_layers.0.0.bias", (dims[0],), "b"),
                       ("downsample_layers.0.1.weight", (dims[0],), "ln_w"),
                       ("downsample_layers.0.1.bias", (dims[0],), "ln_b")]
    for i in range(1, len(dims)):
        out += [(f"downsample_layers.{i}.0.weight", (dims[i - 1],), "ln_w"),
                (f"downsample_layers.{i}.0.bias", (dims[i - 1],), "ln_b"),
                (f"downsample_layers.{i}.1.weight", (dims[i], dims[i - 1], 2, 2), "w"),
                (f"downsample_layers.{i}.1.bias", (dims[i],), "b")]
    for i, (c, depth) in enumerate(zip(dims, depths)):
        for j in range(depth):
            key = f"stages.{i}.{j}"
            out += [(f"{key}.gamma", (c,), "gamma"),
                    (f"{key}.dwconv.weight", (c, 1, 7, 7), "w"),
                    (f"{key}.dwconv.bias", (c,), "b"),
                    (f"{key}.norm.weight", (c,), "ln_w"),
                    (f"{key}.norm.bias", (c,), "ln_b"),
                    (f"{key}.pwconv1.weight", (4 * c, c), "w"),
                    (f"{key}.pwconv1.bias", (4 * c,), "b"),
                    (f"{key}.pwconv2.weight", (c, 4 * c), "w"),
                    (f"{key}.pwconv2.bias", (c,), "b")]
    out += [("norm.weight", (dims[-1],), "ln_w"), ("norm.bias", (dims[-1],), "ln_b"),
            ("head_audioset.weight", (mcfg["num_classes"], dims[-1]), "w"),
            ("head_audioset.bias", (mcfg["num_classes"],), "b")]
    return out


def _stem_kernel(after_stem_dim):
    from benchmark.reference.convnext import stem_geometry

    return stem_geometry(after_stem_dim)


_UNIFORM = {"gamma": (0.1, 0.9), "bn_w": (0.5, 1.5), "bn_rv": (50.0, 150.0)}  # (low, width)
_NORMAL = {"w": (0.0, 0.02), "b": (0.0, 0.02), "ln_w": (1.0, 0.1), "ln_b": (0.0, 0.1),
           "bn_b": (0.0, 0.5), "bn_rm": (-40.0, 5.0)}  # (mean, std)


def make_state_dict(mcfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every entry of the state dict in float32 on ``device``, from ``seed``."""
    device = torch.device(device)
    table = param_table(mcfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in table]
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
            if kind == "w":
                z = z.clamp(-2.0, 2.0)
            mean, std = _NORMAL[kind]
            v = z * std + mean
        else:
            u = uniform[ou:ou + n]
            ou += n
            low, width = _UNIFORM[kind]
            v = u * width + low
        sd[key] = v.reshape(shape).clone()
    return sd
