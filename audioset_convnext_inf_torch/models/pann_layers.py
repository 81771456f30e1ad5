"""Building blocks of the PANN legacy model zoo, as modules.

The same blocks as the JAX package's ``models/pann_layers.py``, which
rebuilds the shared modules of the reference's pytorch/models.py
(ConvBlock:1877, ConvBlock5x5:1977, ConvBlockSep:2181, AttBlock:2059,
LeeNetConvBlock:4271/4362, DaiNetResBlock:4469, _Resnet*:3246-3435,
_ResnetBasicBlockWav1d:4609, ConvPreWavBlock:4855, MobileNet blocks:4000+).

Layouts are the reference's: 2-D maps NCHW (B, C, time, mel), 1-D maps NCL.
Each module holds its parameters under the reference's names, so a
reference state dict loads into the zoo's models as it is. BatchNorm runs
in eval mode from its running statistics, folded to one scale and shift
(``layers.batch_norm_apply``). Inside a training forward (``TrainCtx``,
the JAX package's ``BnCtx`` and ``KeyStream``, pann_layers.py:66-101) it
normalizes with the batch's statistics and reports the new running
statistics by the JAX package's dotted parameter path, leaving its own
buffers as they were; ``dropout`` and SpecAugment draw there, or take the
draws a caller hands in.

The bf16 serving route (``conv_bn_relu``, ``serve_pool``,
``to_serve_layout`` and the blocks' ``serve`` methods) runs channels last,
each eval BatchNorm folded into the convolution before it.

Initialization (``init_params_``) is the JAX package's recipe drawn from a
``torch.Generator``: Glorot-uniform convs and linears with zero biases, BN
at identity, and the JAX init's zeros: the last BN scale of every residual
block and the deformable offset and modulator convs, so that at init a
residual block is its identity path and a deformable conv a regular one.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audioset_convnext_inf_torch.config import SpecAugmentConfig
from audioset_convnext_inf_torch.models import layers as L
from audioset_convnext_inf_torch.models.convnext import BatchNorm0, LayerNorm
from audioset_convnext_inf_torch.ops import specaugment as S
from audioset_convnext_inf_torch.ops.deform_conv import deform_conv2d

# ---------------------------------------------------------------------------
# Training mode: batch-statistic BN, dropout, SpecAugment draws
# ---------------------------------------------------------------------------


class TrainCtx:
    """One training forward (the JAX package's ``BnCtx`` with its
    ``KeyStream``, pann_layers.py:66-101).

    ``updates`` collects each BatchNorm's new running statistics by its
    dotted path in the JAX package's parameter pytree (``bn_path``), with
    its scale and bias, as the JAX ``bn_updates``. Random draws come from
    ``generator`` (on its device), or from ``draws``: one entry for each
    key the JAX function takes from its ``KeyStream``, in that order: a
    SpecAugment draw ((time stripes, frequency stripes), as
    ``ops/specaugment.py`` draws them) or a dropout keep mask in the JAX
    layout, channels last ((B, C), (B, L, C) or (B, T, F, C); None where
    the rate is 0 and JAX draws a key but no mask)."""

    def __init__(self, generator: Optional[torch.Generator], draws=None):
        self.generator = generator
        self._draws: Optional[Iterator[Any]] = None if draws is None else iter(draws)
        self.updates: Dict[str, Dict[str, torch.Tensor]] = {}

    def draw(self, make: Callable[[], Any]) -> Any:
        """The next handed-in draw, else ``make()``."""
        if self._draws is None:
            return make()
        try:
            return next(self._draws)
        except StopIteration:
            raise ValueError("the training forward took more draws than were handed in") from None

    def finish(self) -> None:
        if self._draws is not None and next(self._draws, StopIteration) is not StopIteration:
            raise ValueError("the training forward took fewer draws than were handed in")

    def batch_norm(self, bn: "BatchNorm", x: torch.Tensor, axis: int) -> torch.Tensor:
        """Batch statistics over every axis but ``axis``; the running update
        (momentum 0.1, unbiased variance) goes to ``updates``, not to ``bn``."""
        mean, var = bn.running_mean.clone(), bn.running_var.clone()
        y = L.batch_norm_train(x, bn.weight, bn.bias, mean, var, axis=axis)
        self.updates[bn.path] = {"mean": mean, "var": var, "scale": bn.weight, "bias": bn.bias}
        return y

    def drop(self, x: torch.Tensor, rate: float, channel_dim: int) -> torch.Tensor:
        """x * mask / keep, mask ~ Bernoulli(keep = 1 - rate)."""
        keep = 1.0 - rate

        def make():
            if rate == 0.0:
                return None
            shape = list(x.shape)
            shape.append(shape.pop(channel_dim))
            g = self.generator
            return torch.rand(shape, generator=g, device=g.device) < keep

        mask = self.draw(make)
        if mask is None or rate == 0.0:
            return x
        mask = torch.as_tensor(mask).to(device=x.device, dtype=x.dtype).movedim(-1, channel_dim)
        return x * mask / keep

    def spec_augment(self, x: torch.Tensor, time_axis: int, freq_axis: int,
                     cfg: SpecAugmentConfig) -> torch.Tensor:
        def make():
            b, g = x.shape[0], self.generator
            return (S.draw_stripes(g, b, cfg.time_drop_width, cfg.time_stripes_num),
                    S.draw_stripes(g, b, cfg.freq_drop_width, cfg.freq_stripes_num))

        return S.spec_augment(x, time_axis, freq_axis, cfg, draws=self.draw(make))


_TRAIN: ContextVar[Optional[TrainCtx]] = ContextVar("pann_train", default=None)


def train_ctx() -> Optional[TrainCtx]:
    """The training forward running in this context, or None (eval)."""
    return _TRAIN.get()


@contextlib.contextmanager
def training(ctx: TrainCtx) -> Iterator[TrainCtx]:
    token = _TRAIN.set(ctx)
    try:
        yield ctx
    finally:
        _TRAIN.reset(token)


def dropout(x: torch.Tensor, rate: float, channel_dim: int = 1) -> torch.Tensor:
    """The JAX package's ``dropout`` (pann_layers.py:86): keep with
    probability 1 - rate, scale by 1/keep; the identity outside a training
    forward. ``channel_dim``: x's channel axis (its mask is drawn channels
    last)."""
    ctx = _TRAIN.get()
    return x if ctx is None else ctx.drop(x, rate, channel_dim)


# ---------------------------------------------------------------------------
# Norms, pools, initialization
# ---------------------------------------------------------------------------


class BatchNorm(BatchNorm0):
    """BatchNorm over one axis (the channels, axis 1, by default): the
    reference's four entries, without ``num_batches_tracked``. Eval mode
    folds the running statistics; in a training forward the batch's own
    statistics (``TrainCtx.batch_norm``). ``path`` is its dotted path in the
    JAX package's pytree, set by the model."""

    path = ""

    def forward(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        ctx = _TRAIN.get()
        if ctx is not None:
            return ctx.batch_norm(self, x, axis)
        return L.batch_norm_apply(x, self.weight, self.bias, self.running_mean,
                                  self.running_var, axis=axis)


class LayerNorm2d(LayerNorm):
    """LayerNorm over axis 1 of an NCHW map (the reference's channels_first
    LayerNorm)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def conv2d(in_ch: int, out_ch: int, k: int, padding: int = 0, stride: int = 1,
           groups: int = 1, bias: bool = False) -> nn.Conv2d:
    """An uninitialized Conv2d (``init_params_`` draws its weights)."""
    return nn.utils.skip_init(nn.Conv2d, in_ch, out_ch, k, stride, padding, groups=groups,
                              bias=bias)


def conv1d(in_ch: int, out_ch: int, k: int, padding: int = 0, stride: int = 1,
           dilation: int = 1, bias: bool = False) -> nn.Conv1d:
    return nn.utils.skip_init(nn.Conv1d, in_ch, out_ch, k, stride, padding, dilation,
                              bias=bias)


def linear(in_dim: int, out_dim: int) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, in_dim, out_dim)


@torch.no_grad()
def init_params_(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's PANN init, in module order: Glorot-uniform conv
    and linear weights and zero biases, BN and LN at identity; then each
    block's own zeros (``post_init_``)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            nn.init.xavier_uniform_(mod.weight, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            L.init_batch_norm_(mod)
        elif isinstance(mod, LayerNorm):
            L.init_layer_norm_(mod)
    for mod in model.modules():
        if hasattr(mod, "post_init_"):
            mod.post_init_(generator)


def pool2d(x: torch.Tensor, pool_size: Tuple[int, int], pool_type: str = "avg") -> torch.Tensor:
    """NCHW pooling with kernel = stride, floor (torch's F.*_pool2d
    defaults). "no", and avg or max at (1, 1), are the identity."""
    pool_size = tuple(pool_size)
    if pool_type == "no" or (pool_size == (1, 1) and pool_type in ("avg", "max")):
        return x
    if pool_type == "avg":
        return F.avg_pool2d(x, pool_size)
    if pool_type == "max":
        return F.max_pool2d(x, pool_size)
    if pool_type == "avg+max":
        return F.avg_pool2d(x, pool_size) + F.max_pool2d(x, pool_size)
    raise ValueError(f"Incorrect pool_type {pool_type!r}")


def pool1d(x: torch.Tensor, kernel: int, stride: Optional[int] = None, padding: int = 0,
           pool_type: str = "max") -> torch.Tensor:
    """NCL pooling, stride = kernel by default: max pads with -inf, avg
    counts the padding (torch's ``count_include_pad=True``)."""
    stride = stride or kernel
    if pool_type == "max":
        return F.max_pool1d(x, kernel, stride, padding)
    return F.avg_pool1d(x, kernel, stride, padding, count_include_pad=True)


# ---------------------------------------------------------------------------
# bf16 serving route (eval only)
# ---------------------------------------------------------------------------
# Maps are channels last (NHWC), the layout of cuDNN's bf16 tensor-core
# convolutions; 1-D maps run as (B, C, 1, L) images. Each convolution
# carries its BatchNorm (folded once per version of the weights) and, on
# the card, its bias and ReLU in one cuDNN call; the pools reduce over a
# reshaped view. Each choice was measured on an H100 (PERF.md, section 6).


def fold_bn(weight: torch.Tensor, bn: "BatchNorm") -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight * s, beta - mean * s) in f32, s = gamma / sqrt(var + eps):
    a bias-free convolution followed by an eval BatchNorm as one
    convolution with a bias."""
    s = torch.rsqrt(bn.running_var.float() + 1e-5) * bn.weight.float()
    w = weight.float() * s.reshape((-1,) + (1,) * (weight.ndim - 1))
    return w, bn.bias.float() - bn.running_mean.float() * s


def _folded(conv: nn.Module, bn: "BatchNorm", dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fold_bn``'s weight (channels last, a Conv1d's as (O, I, 1, k)) and
    bias in ``dtype``, kept on ``conv`` and made anew when one of the five
    tensors changes: a ``load_state_dict`` or any in-place update bumps its
    version, a move to another device changes its address."""
    key = tuple((t.data_ptr(), t._version) for t in (
        conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)) + (dtype,)
    kept = conv.__dict__.get("_serve_folded")
    if kept is None or kept[0] != key:
        w, b = fold_bn(conv.weight, bn)
        if isinstance(conv, nn.Conv1d):
            w = w[:, :, None, :]
        kept = (key, w.to(dtype).contiguous(memory_format=torch.channels_last), b.to(dtype))
        conv.__dict__["_serve_folded"] = kept
    return kept[1], kept[2]


def conv_bn_relu(x: torch.Tensor, conv: nn.Module, bn: "BatchNorm") -> torch.Tensor:
    """relu(bn(conv(x))) on a bf16 channels-last map, the BatchNorm folded
    into the convolution, whose weight and bias are rounded to x's dtype
    (``_folded``). On the card one cuDNN call adds the bias and applies the
    ReLU to the f32 accumulator before the output is rounded
    (``torch.cudnn_convolution_relu``); elsewhere the convolution rounds,
    then the ReLU. A Conv1d runs as a (1, k) Conv2d on a (B, C, 1, L) map."""
    w, b = _folded(conv, bn, x.dtype)
    stride, padding, dilation = conv.stride, conv.padding, conv.dilation
    if isinstance(conv, nn.Conv1d):
        stride, padding, dilation = (1,) + stride, (0,) + padding, (1,) + dilation
    if x.is_cuda:
        return torch.cudnn_convolution_relu(x, w, b, stride, padding, dilation, 1)
    return F.relu_(F.conv2d(x, w, b, stride, padding, dilation))


def serve_pool(x: torch.Tensor, size: Tuple[int, int], kind: str = "avg") -> torch.Tensor:
    """Average or max pool (kernel = stride, floor) of a channels-last map
    as one reduction over a (B, H', kh, W', kw, C) view of its memory:
    ``F.avg_pool2d``'s and ``F.max_pool2d``'s channels-last kernels take
    two to four times as long on the card. The mean accumulates in f32."""
    kh, kw = size
    if (kh, kw) == (1, 1):
        return x
    b, c, h, w = x.shape
    v = x.permute(0, 2, 3, 1)[:, :h // kh * kh, :w // kw * kw]
    v = v.reshape(b, h // kh, kh, w // kw, kw, c)
    v = v.mean(dim=(2, 4)) if kind == "avg" else v.amax(dim=(2, 4))
    return v.permute(0, 3, 1, 2)


def to_serve_layout(x: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) channels last. A one-channel map gets the
    channels-last strides on its own memory: ``contiguous(memory_format=
    torch.channels_last)`` leaves such a map as it is, and cuDNN would then
    read it, and write every map after it, channels first."""
    if x.shape[1] == 1:
        _, _, h, w = x.shape
        return x.contiguous().as_strided(x.shape, (h * w, 1, w, 1))
    return x.contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# 2-D conv blocks
# ---------------------------------------------------------------------------


class ConvBlock(nn.Module):
    """Two 3x3 convs, each with BN and ReLU, then a pool (models.py:1877)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = conv2d(in_ch, out_ch, 3, padding=1)
        self.conv2 = conv2d(out_ch, out_ch, 3, padding=1)
        self.bn1 = BatchNorm(out_ch)
        self.bn2 = BatchNorm(out_ch)

    def forward(self, x, pool_size=(2, 2), pool_type="avg"):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return pool2d(x, pool_size, pool_type)

    def serve(self, x, pool_size=(2, 2)):
        """``forward`` with an average pool on the bf16 serving route."""
        x = conv_bn_relu(conv_bn_relu(x, self.conv1, self.bn1), self.conv2, self.bn2)
        return serve_pool(x, pool_size)


class ConvBlock5x5(nn.Module):
    """One 5x5 conv with BN and ReLU, then a pool (models.py:1977)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = conv2d(in_ch, out_ch, 5, padding=2)
        self.bn1 = BatchNorm(out_ch)

    def forward(self, x, pool_size=(2, 2), pool_type="avg"):
        return pool2d(F.relu(self.bn1(self.conv1(x))), pool_size, pool_type)


class ConvBlockSep(nn.Module):
    """A 3x3 conv then a 3x3 depthwise conv (models.py:2181)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = conv2d(in_ch, out_ch, 3, padding=1)
        self.conv2 = conv2d(out_ch, out_ch, 3, padding=1, groups=out_ch)
        self.bn1 = BatchNorm(out_ch)
        self.bn2 = BatchNorm(out_ch)

    def forward(self, x, pool_size=(2, 2), pool_type="avg"):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return pool2d(x, pool_size, pool_type)


class ConvBlockSepPW(ConvBlockSep):
    """ConvBlockSep and a 2x-expansion pointwise MLP with erf GELU over the
    channels, no norm or activation after it (models.py:2330-2399)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch)
        self.pwconv1 = linear(out_ch, 2 * out_ch)
        self.pwconv2 = linear(2 * out_ch, out_ch)

    def forward(self, x, pool_size=(2, 2), pool_type="avg"):
        x = super().forward(x, (1, 1), "no").permute(0, 2, 3, 1)
        x = self.pwconv2(L.gelu(self.pwconv1(x))).permute(0, 3, 1, 2)
        return pool2d(x, pool_size, pool_type)


class DeformableConv2d(nn.Module):
    """The reference's DeformableConv2d (models.py:202-265): offsets from a
    conv, clamped to max(h, w)/4; modulator 2*sigmoid(conv); then
    ``deform_conv2d`` with the regular conv's weight. The JAX init zeroes
    the offset and modulator convs and draws the regular conv from a
    truncated normal (std 0.02)."""

    def __init__(self, in_ch: int, out_ch: int, k: int):
        super().__init__()
        pad = k // 2
        self.offset_conv = conv2d(in_ch, 2 * k * k, k, padding=pad, bias=True)
        self.modulator_conv = conv2d(in_ch, k * k, k, padding=pad, bias=True)
        self.regular_conv = conv2d(in_ch, out_ch, k, padding=pad)
        self.k = k

    @torch.no_grad()
    def post_init_(self, generator: torch.Generator) -> None:
        for conv in (self.offset_conv, self.modulator_conv):
            conv.weight.zero_()
            conv.bias.zero_()
        L.init_conv_(self.regular_conv, generator)

    def forward(self, x):
        pad = self.k // 2
        max_offset = max(x.shape[2], x.shape[3]) / 4.0
        offset = torch.clamp(self.offset_conv(x), -max_offset, max_offset)
        modulator = 2.0 * torch.sigmoid(self.modulator_conv(x))
        return deform_conv2d(x, offset, self.regular_conv.weight, mask=modulator,
                             padding=(pad, pad))


class ConvBlockDeformable(nn.Module):
    """ConvBlock (kernel 3: two convs) or ConvBlock5x5 (kernel 5: one) with
    deformable convs (models.py:1877-1929 with deformable=True)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
        super().__init__()
        self.conv1 = DeformableConv2d(in_ch, out_ch, kernel)
        self.bn1 = BatchNorm(out_ch)
        if kernel == 3:
            self.conv2 = DeformableConv2d(out_ch, out_ch, kernel)
            self.bn2 = BatchNorm(out_ch)

    def forward(self, x, pool_size=(2, 2), pool_type="avg"):
        x = F.relu(self.bn1(self.conv1(x)))
        if hasattr(self, "conv2"):
            x = F.relu(self.bn2(self.conv2(x)))
        return pool2d(x, pool_size, pool_type)


# ---------------------------------------------------------------------------
# Attention pooling (models.py AttBlock:2059-2088)
# ---------------------------------------------------------------------------


class AttBlock(nn.Module):
    """Decision-level attention over time: x (B, n_in, T) -> (clipwise
    (B, n_out), norm_att, cla (B, n_out, T)); softmax over time of the
    attention logits clamped to [-10, 10], sigmoid classes (the only
    activation the zoo uses)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.att = conv1d(n_in, n_out, 1, bias=True)
        self.cla = conv1d(n_in, n_out, 1, bias=True)

    def forward(self, x):
        norm_att = torch.softmax(torch.clamp(self.att(x), -10, 10), dim=-1)
        cla = torch.sigmoid(self.cla(x))
        return torch.sum(norm_att * cla, dim=-1), norm_att, cla


# ---------------------------------------------------------------------------
# 1-D waveform blocks
# ---------------------------------------------------------------------------


class LeeBlock(nn.Module):
    """Conv1d (stride at construction) with BN and ReLU, then a max pool
    padded by pool_size//2 (models.py:4271)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int):
        super().__init__()
        self.conv1 = conv1d(in_ch, out_ch, kernel, padding=kernel // 2, stride=stride)
        self.bn1 = BatchNorm(out_ch)

    def forward(self, x, pool_size: int = 1):
        x = F.relu(self.bn1(self.conv1(x)))
        if pool_size != 1:
            x = pool1d(x, pool_size, padding=pool_size // 2)
        return x


class LeeBlock2(LeeBlock):
    """LeeBlock with a second (stride-1) conv, BN and ReLU (models.py:4362)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int):
        super().__init__(in_ch, out_ch, kernel, stride)
        self.conv2 = conv1d(out_ch, out_ch, kernel, padding=kernel // 2)
        self.bn2 = BatchNorm(out_ch)

    def forward(self, x, pool_size: int = 1):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        if pool_size != 1:
            x = pool1d(x, pool_size, padding=pool_size // 2)
        return x


class DaiBlock(nn.Module):
    """DaiNet's residual block (models.py:4469): four convs with BN (ReLU
    after the first three), the identity or a 1x1 conv and BN, ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}",
                    conv1d(out_ch if i else in_ch, out_ch, kernel, padding=kernel // 2))
        self.downsample = conv1d(in_ch, out_ch, 1)
        for i in range(4):
            setattr(self, f"bn{i + 1}", BatchNorm(out_ch))
        self.bn_downsample = BatchNorm(out_ch)

    @torch.no_grad()
    def post_init_(self, generator: torch.Generator) -> None:
        self.bn4.weight.zero_()

    def forward(self, x, pool_size: int = 1):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = F.relu(self.bn3(self.conv3(out)))
        out = self.bn4(self.conv4(out))
        if x.shape == out.shape:
            out = F.relu(out + x)
        else:
            out = F.relu(out + self.bn_downsample(self.downsample(x)))
        if pool_size != 1:
            out = pool1d(out, pool_size, padding=pool_size // 2)
        return out


class PreWavBlock(nn.Module):
    """The wavegram's pre-block: conv, dilated conv (each with BN and
    ReLU), max pool (models.py:4855-4890)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = conv1d(in_ch, out_ch, 3, padding=1)
        self.conv2 = conv1d(out_ch, out_ch, 3, padding=2, dilation=2)
        self.bn1 = BatchNorm(out_ch)
        self.bn2 = BatchNorm(out_ch)

    def forward(self, x, pool_size: int):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return pool1d(x, pool_size)

    def serve(self, x, pool_size: int):
        """``forward`` on the bf16 serving route, x (B, C, 1, L)."""
        x = conv_bn_relu(conv_bn_relu(x, self.conv1, self.bn1), self.conv2, self.bn2)
        return serve_pool(x, (1, pool_size), "max")


# ---------------------------------------------------------------------------
# ResNet 2-D (models.py:3246-3435) and 1-D (4609-4744)
# ---------------------------------------------------------------------------


def _downsample(stage: int, stride: int, conv: nn.Module, out_ch: int, pool) -> nn.Sequential:
    """The reference's downsample Sequential: [conv, bn] at stage 0, [avg
    pool, conv, bn] after it (so its keys are .0/.1, then .1/.2)."""
    if stage == 0:
        return nn.Sequential(conv, BatchNorm(out_ch))
    return nn.Sequential(pool(stride), conv, BatchNorm(out_ch))


class ResnetBasicBlock(nn.Module):
    """Basic block; stride 2 is an avg pool before conv1 (and in the
    downsample); dropout 0.1 after the first ReLU in training. The JAX init
    zeroes bn2's scale."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int, stage: int, downsample: bool):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 3, padding=1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv2d(planes, planes, 3, padding=1)
        self.bn2 = BatchNorm(planes)
        self.stride = stride
        if downsample:
            self.downsample = _downsample(stage, stride, conv2d(inplanes, planes, 1), planes,
                                          nn.AvgPool2d)

    @torch.no_grad()
    def post_init_(self, generator: torch.Generator) -> None:
        self.bn2.weight.zero_()

    def forward(self, x):
        out = pool2d(x, (2, 2), "avg") if self.stride == 2 else x
        out = dropout(F.relu(self.bn1(self.conv1(out))), 0.1)
        out = self.bn2(self.conv2(out))
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(out + identity)


class ResnetBottleneck(nn.Module):
    """Bottleneck block (1x1, 3x3, 1x1 to 4x planes); stride 2 pools the
    input first; dropout 0.1 after the second ReLU in training. The JAX
    init zeroes bn3's scale."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int, stage: int, downsample: bool):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv2d(planes, planes, 3, padding=1)
        self.bn2 = BatchNorm(planes)
        self.conv3 = conv2d(planes, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
        self.stride = stride
        if downsample:
            self.downsample = _downsample(stage, stride, conv2d(inplanes, planes * 4, 1),
                                          planes * 4, nn.AvgPool2d)

    @torch.no_grad()
    def post_init_(self, generator: torch.Generator) -> None:
        self.bn3.weight.zero_()

    def forward(self, x):
        out = pool2d(x, (2, 2), "avg") if self.stride == 2 else x
        out = F.relu(self.bn1(self.conv1(out)))
        out = dropout(F.relu(self.bn2(self.conv2(out))), 0.1)
        out = self.bn3(self.conv3(out))
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(out + identity)


class Resnet(nn.Module):
    """The 2-D trunk: ``layer1..4`` of basic or bottleneck blocks over
    64-512 planes, stride 2 from the second stage."""

    def __init__(self, block_type: str, layers: Sequence[int]):
        super().__init__()
        block = ResnetBasicBlock if block_type == "basic" else ResnetBottleneck
        inplanes = 64
        for si, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for b in range(n):
                s = (1 if si == 0 else 2) if b == 0 else 1
                ds = b == 0 and (s != 1 or inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes, s, si, ds))
                inplanes = planes * block.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.num_layers = len(layers)

    def forward(self, x):
        for si in range(self.num_layers):
            x = getattr(self, f"layer{si + 1}")(x)
        return x


class Res1dBlock(nn.Module):
    """1-D basic block (models.py:4609): the main branch max-pools by the
    stride, the downsample avg-pools; the second conv has dilation 2;
    dropout 0.1 after the first ReLU in training. The JAX init zeroes bn2's
    scale."""

    def __init__(self, inplanes: int, planes: int, stride: int, stage: int, downsample: bool):
        super().__init__()
        self.conv1 = conv1d(inplanes, planes, 3, padding=1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv1d(planes, planes, 3, padding=2, dilation=2)
        self.bn2 = BatchNorm(planes)
        self.stride = stride
        if downsample:
            self.downsample = _downsample(stage, stride, conv1d(inplanes, planes, 1), planes,
                                          nn.AvgPool1d)

    @torch.no_grad()
    def post_init_(self, generator: torch.Generator) -> None:
        self.bn2.weight.zero_()

    def forward(self, x):
        out = pool1d(x, self.stride) if self.stride != 1 else x
        out = dropout(F.relu(self.bn1(self.conv1(out))), 0.1)
        out = self.bn2(self.conv2(out))
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(out + identity)


_RES1D_PLANES = (64, 128, 256, 512, 1024, 1024, 2048)


class Res1dNet(nn.Module):
    """The 1-D trunk: ``layer1..7`` over _RES1D_PLANES, stride 4 from the
    second stage."""

    def __init__(self, layers: Sequence[int]):
        super().__init__()
        inplanes = 64
        for si, (planes, n) in enumerate(zip(_RES1D_PLANES, layers)):
            blocks = []
            for b in range(n):
                s = (1 if si == 0 else 4) if b == 0 else 1
                ds = b == 0 and (s != 1 or inplanes != planes)
                blocks.append(Res1dBlock(inplanes, planes, s, si, ds))
                inplanes = planes
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.num_layers = min(len(layers), len(_RES1D_PLANES))

    def forward(self, x):
        for si in range(self.num_layers):
            x = getattr(self, f"layer{si + 1}")(x)
        return x


# ---------------------------------------------------------------------------
# MobileNet blocks (models.py:4000-4141); stride is an avg pool after the
# conv, at the reference's Sequential index
# ---------------------------------------------------------------------------


def _stride_pool(stride: int) -> nn.Module:
    return nn.AvgPool2d(stride) if stride > 1 else nn.Identity()


def mb_conv_bn(inp: int, oup: int, stride: int) -> nn.Sequential:
    """[3x3 conv, pool, BN, ReLU]."""
    return nn.Sequential(conv2d(inp, oup, 3, padding=1), _stride_pool(stride), BatchNorm(oup),
                         nn.ReLU())


def mb_conv_dw(inp: int, oup: int, stride: int) -> nn.Sequential:
    """[3x3 depthwise, pool, BN, ReLU, 1x1, BN, ReLU]."""
    return nn.Sequential(conv2d(inp, inp, 3, padding=1, groups=inp), _stride_pool(stride),
                         BatchNorm(inp), nn.ReLU(), conv2d(inp, oup, 1), BatchNorm(oup),
                         nn.ReLU())


class InvertedResidual(nn.Module):
    """MobileNetV2's block: ``conv`` is [dw, pool, BN, ReLU6, 1x1, BN] at
    expand ratio 1, else [1x1 expand, BN, ReLU6, dw, pool, BN, ReLU6, 1x1,
    BN]; the input is added where stride is 1 and the widths agree."""

    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = round(inp * expand_ratio)
        tail = [conv2d(hidden, hidden, 3, padding=1, groups=hidden), _stride_pool(stride),
                BatchNorm(hidden), nn.ReLU6(), conv2d(hidden, oup, 1), BatchNorm(oup)]
        head = [] if expand_ratio == 1 else [conv2d(inp, hidden, 1), BatchNorm(hidden),
                                             nn.ReLU6()]
        self.conv = nn.Sequential(*head, *tail)
        self.use_res = stride == 1 and inp == oup

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


# ---------------------------------------------------------------------------
# SED helpers (pytorch_utils.py:140-177)
# ---------------------------------------------------------------------------


def interpolate_time(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """(B, T, C) -> (B, T*ratio, C), each frame repeated ``ratio`` times."""
    return torch.repeat_interleave(x, ratio, dim=1)


def pad_framewise_output(framewise: torch.Tensor, frames_num: int) -> torch.Tensor:
    """(B, T, C) to ``frames_num`` frames: truncated, or padded with the
    last frame."""
    t = framewise.shape[1]
    if t >= frames_num:
        return framewise[:, :frames_num]
    pad = framewise[:, -1:].expand(-1, frames_num - t, -1)
    return torch.cat([framewise, pad], dim=1)
