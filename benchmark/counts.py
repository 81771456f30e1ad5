"""Operation and byte counts of the audio ConvNeXt, and the card's peaks.

Counts are what the mathematics needs, from the configuration's shapes, so
no implementation can read above them: twice the multiply-adds of every
product (stem, 7x7 depthwise stencils, pointwise layers, downsamples, head,
mel product) and the STFT as an FFT (5 N log2 N a frame). Elementwise work
(LayerNorm, GELU, the residual) is not counted.

A kernel's least time is max(FLOPs / peak, bytes / bandwidth), with each
input byte read once, each output byte written once and the weights read
once, in the precision the kernel computes in; its roofline share is that
least time over its measured device time.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16, F32 = 2, 4


def frames(mcfg: dict, samples: int) -> int:
    fe = mcfg["frontend"]
    return (samples + 2 * (fe["n_fft"] // 2) - fe["n_fft"]) // fe["hop_length"] + 1


def stage_shapes(mcfg: dict, samples: int) -> List[Tuple[int, int, int]]:
    """(H, W, C) of each stage: the stem's output, then halved per stage."""
    fe = mcfg["frontend"]
    t, m = frames(mcfg, samples), fe["n_mels"]
    (kh, kw), (sh, sw), (ph, pw) = _stem(mcfg)
    h = (t + 2 * ph - kh) // sh + 1
    w = (m + 2 * pw - kw) // sw + 1
    out = []
    for i, c in enumerate(mcfg["dims"]):
        if i > 0:
            h, w = h // 2, w // 2
        out.append((h, w, c))
    return out


def _stem(mcfg):
    from benchmark.reference.convnext import stem_geometry

    return stem_geometry(mcfg["after_stem_dim"])


def block_macs(h: int, w: int, c: int) -> int:
    """Multiply-adds of one block's forward: 7x7 depthwise and the two
    pointwise layers (C -> 4C -> C)."""
    return h * w * c * (49 + 8 * c)


def frontend_flops(mcfg: dict, samples: int) -> float:
    """FFT of every frame (5 N log2 N) and the mel product, per clip."""
    fe = mcfg["frontend"]
    n, t = fe["n_fft"], frames(mcfg, samples)
    return t * 5 * n * math.log2(n) + 2 * t * (n // 2 + 1) * fe["n_mels"]


def trunk_macs(mcfg: dict, samples: int) -> Dict[str, int]:
    """Multiply-adds per clip by part: stem, each stage, downsamples, head."""
    shapes = stage_shapes(mcfg, samples)
    (kh, kw), _, _ = _stem(mcfg)
    h0, w0, c0 = shapes[0]
    out = {"stem": h0 * w0 * c0 * kh * kw}
    for i, ((h, w, c), depth) in enumerate(zip(shapes, mcfg["depths"])):
        out[f"stage{i + 1}"] = depth * block_macs(h, w, c)
    out["downsamples"] = sum(h * w * c * shapes[i - 1][2] * 4
                             for i, (h, w, c) in enumerate(shapes) if i > 0)
    out["head"] = shapes[-1][2] * mcfg["num_classes"]
    return out


def model_flops(mcfg: dict, samples: int) -> float:
    """Forward FLOPs of one clip: frontend plus twice the trunk's MACs."""
    return frontend_flops(mcfg, samples) + 2.0 * sum(trunk_macs(mcfg, samples).values())


def train_flops(mcfg: dict, samples: int, trunk_clips: float, input_clips: float) -> float:
    """A training step's FLOPs: forward and backward of the trunk (three
    forwards' worth) on the clips after mixup, the frontend's forward on
    the clips that came in."""
    trunk = 2.0 * sum(trunk_macs(mcfg, samples).values())
    return 3.0 * trunk * trunk_clips + frontend_flops(mcfg, samples) * input_clips


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def _weights_bytes(c: int) -> Tuple[int, int]:
    """(bf16 product weights, f32 vectors) of one block, in elements."""
    return 49 * c + 8 * c * c, 8 * c  # dw + W1 + W2; dw_b, ln w/b, b1 (4C), b2, gamma


def k1_counts(shape: Sequence[int]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one fused block forward in serving mode on a bf16
    NHWC input of ``shape``: x read, y written, the weights read once."""
    b, h, w, c = shape
    px = b * h * w
    mats, vecs = _weights_bytes(c)
    return 2.0 * block_macs(b * h, w, c), 2 * px * c * BF16 + mats * BF16 + vecs * F32


def k2_counts(shape: Sequence[int]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one fused block backward on a bf16 NHWC input of
    ``shape``, given the saved block input x and depthwise output d.

    The products it needs, per pixel: the first pointwise layer again
    (4C^2, the GELU input is not saved), the data and weight gradients of
    both pointwise layers (4 x 4C^2), and the depthwise stencil's data and
    weight gradients (2 x 49C). gamma's gradient follows from the second
    layer's weight gradient and needs no product of its own. Bytes: x, d
    and dy read, dx written (bf16), the weights read (bf16) and every
    weight gradient written (f32)."""
    b, h, w, c = shape
    px = b * h * w
    mats, vecs = _weights_bytes(c)
    flops = 2.0 * px * (20 * c * c + 98 * c)
    nbytes = 4 * px * c * BF16 + mats * BF16 + vecs * F32 + (mats + vecs) * F32
    return flops, nbytes
