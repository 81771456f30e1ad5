"""Plain float32 Wavegram-Logmel-CNN14: the benchmark's reference for PANNs.

Written from the published ``Wavegram_Logmel_Cnn14.forward`` (Kong et al.
2020, "PANNs: Large-Scale Pretrained Audio Neural Networks for Audio
Pattern Recognition", arXiv:1912.10211; qiuqiangkong/audioset_tagging_cnn
``pytorch/models.py``, copied into topel/audioset-convnext-inf
``pytorch/models.py:4892-5205``) in eval mode, in plain ``torch``
operations and NCHW / NCL, with TF32 off, and importing nothing of the
program under test:

 - the int16 decode (x / 32767, the AudioSet HDF5 convention);
 - the Wavegram branch: ``pre_conv0`` (Conv1d 1 -> 64, k 11, stride 5,
   padding 5), ``pre_bn0``, ReLU; three ``ConvPreWavBlock``s (Conv1d k 3,
   BN, ReLU, Conv1d k 3 dilation 2, BN, ReLU, max pool 4); the reshape of
   the (B, 128, L) map into (B, 4, 32, L), transposed to (B, 4, L, 32);
   ``pre_block4``, a ``ConvBlock(4, 64)`` pooled (2, 1);
 - the log-mel (torchlibrosa's ``Spectrogram`` + ``LogmelFilterBank``,
   ``benchmark/reference/convnext.py``'s ``log_mel``), bn0 over the mel
   bins, ``conv_block1`` (``ConvBlock(1, 64)``, two 3x3 convolutions each
   with BN and ReLU, 2x2 average pool);
 - the channel concat of the two (B, 64, T/2, 32) maps, ``conv_block2`` to
   ``conv_block6`` (128 -> 2048 channels, 2x2 average pools, none after
   block 6), the mean over frequency, then max + mean over time, ``fc1``
   with ReLU, ``fc_audioset`` and the sigmoid.

Departures from the published code: dropout and SpecAugment are left out
(eval mode: both are the identity). Nothing else.

Every function takes a state dict ``sd`` with the published keys
(``pre_conv0.weight``, ``pre_block1.conv1.weight``, ``bn0.running_mean``,
``conv_block6.bn2.weight``, ``fc_audioset.bias``, ...; no
``num_batches_tracked``) and the configuration's ``model`` as a plain dict.
``quant`` (a float8 dtype or None) rounds both operands of every product
(the mel product, every convolution and linear layer) to that dtype with
one scale per tensor, as ``benchmark/reference/convnext.py`` does: the
reference in a precision below bf16, the control of the correctness check.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.convnext import _q, bn0_eval, conv2d, decode, linear, log_mel, true_f32

StateDict = Dict[str, torch.Tensor]


def conv1d(x, w, quant=None, **kw):
    return F.conv1d(_q(x, quant), _q(w, quant), None, **kw)


def batch_norm(x: torch.Tensor, sd: StateDict, key: str, eps: float) -> torch.Tensor:
    """Eval BatchNorm over axis 1 from the running statistics."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mean, var = sd[key + ".running_mean"].reshape(shape), sd[key + ".running_var"].reshape(shape)
    w, b = sd[key + ".weight"].reshape(shape), sd[key + ".bias"].reshape(shape)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def conv_block(x, sd, key, eps, pool, quant=None):
    """``ConvBlock``: two 3x3 convolutions (padding 1, no bias), each with
    BN and ReLU, then an average pool of ``pool`` (kernel = stride)."""
    x = F.relu(batch_norm(conv2d(x, sd[key + ".conv1.weight"], None, quant, padding=1),
                          sd, key + ".bn1", eps))
    x = F.relu(batch_norm(conv2d(x, sd[key + ".conv2.weight"], None, quant, padding=1),
                          sd, key + ".bn2", eps))
    return F.avg_pool2d(x, pool) if tuple(pool) != (1, 1) else x


def pre_wav_block(x, sd, key, eps, quant=None):
    """``ConvPreWavBlock``: Conv1d k 3 (padding 1), BN, ReLU, Conv1d k 3
    dilation 2 (padding 2), BN, ReLU, max pool 4."""
    x = F.relu(batch_norm(conv1d(x, sd[key + ".conv1.weight"], quant, padding=1),
                          sd, key + ".bn1", eps))
    x = F.relu(batch_norm(conv1d(x, sd[key + ".conv2.weight"], quant, padding=2, dilation=2),
                          sd, key + ".bn2", eps))
    return F.max_pool1d(x, 4)


def wavegram(wave: torch.Tensor, sd: StateDict, mcfg: dict, quant=None) -> torch.Tensor:
    """(B, N) waveform -> (B, 64, L/2, 32) Wavegram map."""
    eps = mcfg["bn_eps"]
    a = conv1d(wave[:, None, :], sd["pre_conv0.weight"], quant, stride=5, padding=5)
    a = F.relu(batch_norm(a, sd, "pre_bn0", eps))
    for i in (1, 2, 3):
        a = pre_wav_block(a, sd, f"pre_block{i}", eps, quant)
    a = a.reshape(a.shape[0], -1, mcfg["wavegram_groups"], a.shape[-1]).transpose(2, 3)
    return conv_block(a, sd, "pre_block4", eps, (2, 1), quant)


def logits(wave: torch.Tensor, sd: StateDict, mcfg: dict, quant=None) -> torch.Tensor:
    """(B, N) f32 waveform -> (B, classes) logits."""
    eps = mcfg["bn_eps"]
    a = wavegram(wave, sd, mcfg, quant)
    x = bn0_eval(log_mel(wave, mcfg, quant), sd, eps)
    x = conv_block(x, sd, "conv_block1", eps, (2, 2), quant)
    x = torch.cat((x, a), dim=1)
    for i in range(2, 7):
        x = conv_block(x, sd, f"conv_block{i}", eps, (2, 2) if i < 6 else (1, 1), quant)
    x = torch.mean(x, dim=3)
    x = torch.amax(x, dim=2) + torch.mean(x, dim=2)
    x = F.relu(linear(x, sd["fc1.weight"], sd["fc1.bias"], quant))
    return linear(x, sd["fc_audioset.weight"], sd["fc_audioset.bias"], quant)


@torch.no_grad()
def probabilities(sd: StateDict, pcm: torch.Tensor, mcfg: dict, quant=None,
                  block_rows: int = 16) -> torch.Tensor:
    """Eval forward of int16 or f32 clips (B, N) -> sigmoid probabilities
    (B, classes) in f32, ``block_rows`` clips at a time."""
    out = []
    with true_f32():
        for i in range(0, pcm.shape[0], block_rows):
            out.append(torch.sigmoid(logits(decode(pcm[i:i + block_rows]), sd, mcfg, quant)))
    return torch.cat(out)
