"""Operation counts of Wavegram-Logmel-CNN14, from the configuration's shapes.

What the mathematics needs, so no implementation can read above it: the
frontend's as ``benchmark/counts.py`` counts it (the STFT as an FFT, the
mel product), plus twice the multiply-adds of every convolution and linear
layer. BatchNorm, ReLU, pooling and the reductions are not counted.
"""

from __future__ import annotations

from typing import Dict

from benchmark import counts


def _conv_block(h: int, w: int, cin: int, cout: int, k: int) -> int:
    """Multiply-adds of a ConvBlock's two k x k convolutions at h x w."""
    return h * w * cout * (cin + cout) * k * k


def macs(mcfg: dict, samples: int) -> Dict[str, int]:
    """Multiply-adds per clip by layer."""
    wc, c = mcfg["wavegram_channels"], mcfg["channels"]
    k0, s0, pool, g = (mcfg["pre_conv0_kernel"], mcfg["pre_conv0_stride"], mcfg["wavegram_pool"],
                       mcfg["wavegram_groups"])
    length = (samples + 2 * (k0 // 2) - k0) // s0 + 1
    out = {"pre_conv0": length * wc[0] * k0}
    for i in range(1, 4):  # two k-3 convolutions, then the max pool
        out[f"pre_block{i}"] = length * wc[i] * (wc[i - 1] + wc[i]) * 3
        length //= pool
    out["pre_block4"] = _conv_block(length, g, wc[3] // g, c[0], 3)
    t = counts.frames(mcfg, samples)
    m = mcfg["frontend"]["n_mels"]
    out["conv_block1"] = _conv_block(t, m, 1, c[0], 3)
    h, w = min(t // 2, length // 2), m // 2
    cin = 2 * c[0]
    for i in range(2, 7):
        out[f"conv_block{i}"] = _conv_block(h, w, cin, c[i - 1], 3)
        cin = c[i - 1]
        if i < 6:
            h, w = h // 2, w // 2
    out["fc1"] = c[-1] * c[-1]
    out["fc_audioset"] = c[-1] * mcfg["num_classes"]
    return out


def model_flops(mcfg: dict, samples: int) -> float:
    """Forward FLOPs of one clip: the frontend's plus twice every MAC."""
    return counts.frontend_flops(mcfg, samples) + 2.0 * sum(macs(mcfg, samples).values())
