"""The PANN legacy model zoo (reference pytorch/models.py).

The same zoo as the JAX package's ``models/pann.py``: one module class per
*family*, with the reference's per-class differences (channel ladders,
frontends, embedding sizes, pooling heads) as :class:`PannConfig` presets
in ``PANN_REGISTRY``, all 49 runnable reference models. Most share the
reference skeleton (e.g. models.py Cnn14:2090-2178): log-mel frontend ->
bn0 over the mel axis -> trunk -> freq mean, time max + mean -> fc1 ->
527-way sigmoid head, giving {"clipwise_output", "clipwise_logits",
"embedding"}; the SED decision-level heads (models.py:5678-5982) give
{"framewise_output", "segmentwise_output", "clipwise_output"}.

Each family's parameters carry the reference's state-dict names
(``conv_block1.conv1.weight``, ``bn0.running_mean``,
``resnet.layer2.0.downsample.1.weight``, ``features.3.conv.7.weight``,
``conv_block5.conv1.offset_conv.weight``, ...), so a reference checkpoint
loads through ``checkpoint.pann_convert.load_pann_state_dict``, which only
drops the frontend's entries. The one exception is ``cnn_next``, whose
reference labels its blocks unevenly; here they are ``conv_block1..n``.

``PannModel.forward`` runs eval-mode inference on a float or int16 PCM
batch (int16 decodes on the card, ``ops/pcm.py``) by its ``compute_dtype``:

 - float32 (the default): true f32, under ``fp32_precision("highest")`` on
   the card, so no TF32 switch of the process changes its answer; the JAX
   package's PANN forward, which is f32 whatever it is given;
 - bfloat16, the serving route of the ``wavegram`` family and of the
   ``cnn`` family with plain double-3x3 conv blocks (``serves_bf16``): the
   log-mel frontend at precision "default" with bn0 folded in, every
   convolution with its BatchNorm folded in, bf16 operands and f32
   accumulation, channels last, its bias and ReLU fused on the card
   (``pann_layers.conv_bn_relu``), ``fc1`` the same; the pooling head's
   reductions, ``fc_audioset`` and the sigmoid in f32. TF32 is never on.

Each model counts its forwards by route (``f32_forwards``,
``bf16_forwards``). The serving route marks ``model.frontend``,
``model.wavegram`` (the wavegram family), ``model.trunk`` and
``model.head`` with ``utils/profiling.py::span``; the f32 route of the
wavegram family marks the same.
``PannModel.forward_train`` is the JAX package's ``forward_train``
(models/pann.py:838) for every family: batch-statistic BN whose new running
statistics come back as ``bn_updates`` (the module's buffers stay as they
were), dropout, SpecAugment and mixup on the spectrogram or the waveform,
with the draws taken from a ``torch.Generator`` or handed in, in the JAX
key stream's order (``pann_layers.TrainCtx``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audioset_convnext_inf_torch.config import NUM_CLASSES, FrontendConfig, SpecAugmentConfig
from audioset_convnext_inf_torch.device import resolve_device
from audioset_convnext_inf_torch.models import layers as L
from audioset_convnext_inf_torch.models import pann_layers as P
from audioset_convnext_inf_torch.models.convnext import LayerNorm
from audioset_convnext_inf_torch.ops.frontend import LogMelFrontend
from audioset_convnext_inf_torch.ops.mixup import do_mixup
from audioset_convnext_inf_torch.ops.pcm import decode_pcm_if_int16
from audioset_convnext_inf_torch.ops.precision import fp32_precision, mm_f32acc
from audioset_convnext_inf_torch.utils.profiling import span

# PANN frontend: 64 mels, fmin 50, fmax 14000 on 32 kHz (models.py:2104-2115);
# SpecAugment freq_drop_width=8 (vs ConvNeXt's 28).
PANN_FRONTEND = FrontendConfig(n_mels=64)
PANN_SPECAUG = SpecAugmentConfig(freq_drop_width=8)

FRONTEND_16K = FrontendConfig(sample_rate=16000, n_fft=512, win_length=512,
                              hop_length=160, n_mels=64, fmax=8000.0)
FRONTEND_8K = FrontendConfig(sample_rate=8000, n_fft=256, win_length=256,
                             hop_length=80, n_mels=64, fmax=4000.0)


@dataclass(frozen=True)
class PannConfig:
    name: str
    family: str  # cnn | cnn_next | sed | resnet | mobilenet_v1 | mobilenet_v2 | leenet | dainet | res1dnet | wavegram
    frontend: FrontendConfig = PANN_FRONTEND
    classes_num: int = NUM_CLASSES
    # cnn family
    channels: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    block: str = "conv"  # conv (double 3x3) | conv5x5 | sep | seppw
    # per-block deformable-conv switches (Cnn14Deformable/Cnn6Deformable,
    # models.py:2503-2602/3054-3149); empty = all regular
    deformable_blocks: Tuple[int, ...] = ()
    fc1_out: int = 0  # 0 = same as trunk output channels
    block_dropout: float = 0.2
    head_dropout: float = 0.5
    use_spec_augment: bool = True
    mixup_on_waveform: bool = False
    # sed family
    sed_head: str = "max"  # max | avg | att
    interpolate_ratio: int = 32
    # resnet family
    resnet_block: str = "basic"
    resnet_layers: Tuple[int, ...] = (2, 2, 2, 2)
    # leenet family
    lee_double: bool = False
    lee_channels: Tuple[int, ...] = (64, 64, 64, 128, 128, 128, 128, 128, 256)
    # res1dnet family
    res1d_layers: Tuple[int, ...] = (2, 2, 2, 2, 2, 2, 2)
    # wavegram family
    wavegram_logmel: bool = False
    # cnn_next hybrid family (models.py:268-1876): non-residual ConvNeXt-ish
    # blocks; each entry = (in_ch, out_ch, kernel, pool_type)
    next_blocks: Tuple[Tuple[int, int, int, str], ...] = ()
    next_stem: bool = True  # Conv2d(1,64,k4,s2) + channels-first LN
    next_group1: bool = False  # BlockGroup1: dwconv stays in->in
    use_fc1: bool = True
    spec_augment: SpecAugmentConfig = PANN_SPECAUG


# ---------------------------------------------------------------------------
# The model: shared prologue, heads and API; one subclass per family
# ---------------------------------------------------------------------------


class PannModel(nn.Module):
    """A zoo model with its config and frontend, on ``device`` (the card
    unless the caller names another). Parameters are drawn on the CPU from
    ``seed`` (``pann_layers.init_params_``), then moved, so a seed gives the
    same weights on every device. The state dict holds exactly the
    reference's keys; the frontend's constants are non-persistent.
    ``compute_dtype`` picks the eval route: float32, or bfloat16 where the
    family has a serving route (``serves_bf16``)."""

    def __init__(self, cfg: PannConfig, device=None, seed: int = 0,
                 compute_dtype=torch.float32):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        if compute_dtype == torch.bfloat16 and not serves_bf16(cfg):
            raise ValueError(f"{cfg.name} has no bf16 route (the wavegram family, and the "
                             f"cnn family with plain conv blocks)")
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        self.device = device
        self.compute_dtype = compute_dtype
        self.f32_forwards = self.bf16_forwards = 0
        self.build(cfg)
        P.init_params_(self, torch.Generator().manual_seed(seed))
        fe = cfg.frontend if compute_dtype == torch.float32 else replace(cfg.frontend,
                                                                         precision="default")
        self.frontend = LogMelFrontend(fe)
        # imported here: the converter imports this module
        from audioset_convnext_inf_torch.checkpoint.pann_convert import bn_path

        for name, mod in self.named_modules():  # each BN's key in bn_updates
            if isinstance(mod, P.BatchNorm):
                mod.path = bn_path(cfg, name)
        self.to(device)
        self.eval()

    def build(self, cfg: PannConfig) -> None:
        raise NotImplementedError

    def compute(self, waveform: torch.Tensor,
                mixup_lambda: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """(B, samples) f32 on the model's device -> the outputs; in a
        training forward, ``mixup_lambda`` (B,) mixes pairs of clips."""
        raise NotImplementedError

    def serve(self, waveform: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The bf16 serving route's eval forward of a (B, samples) f32
        waveform on the model's device."""
        raise NotImplementedError

    @torch.inference_mode()
    def forward(self, waveform) -> Dict[str, torch.Tensor]:
        """Eval-mode outputs of a (B, samples) waveform (numpy or tensor,
        float, or int16 PCM that decodes on the model's device) at the
        config's sample rate, on the ``compute_dtype`` route."""
        x = decode_pcm_if_int16(torch.as_tensor(waveform).to(self.device)).float()
        if self.compute_dtype == torch.bfloat16:
            self.bf16_forwards += 1
            return self.serve(x)
        self.f32_forwards += 1
        with fp32_precision("highest"):
            return self.compute(x)

    def forward_train(self, waveform, generator: Optional[torch.Generator],
                      mixup_lambda=None, draws: Optional[Sequence] = None
                      ) -> Dict[str, object]:
        """The training forward (the JAX package's ``forward_train``,
        models/pann.py:838), in true f32, differentiable: the outputs and
        ``bn_updates`` ({dotted path: {"mean", "var", "scale", "bias"}}, the
        running statistics after this batch). The module's buffers stay as
        they were (``engine.transfer.merge_bn_stats`` writes them). Draws
        come from ``generator`` (on its device) unless ``draws`` hands them
        in (``pann_layers.TrainCtx``); with ``mixup_lambda`` (2B,) the 2B
        clips mix in pairs into B."""
        x = torch.as_tensor(waveform).to(self.device, torch.float32)
        lam = None if mixup_lambda is None else torch.as_tensor(mixup_lambda).to(self.device)
        ctx = P.TrainCtx(generator, draws)
        with P.training(ctx), fp32_precision("highest"):
            out = self.compute(x, lam)
        ctx.finish()
        out["bn_updates"] = ctx.updates
        return out

    def count_parameters(self) -> int:
        """Parameters without the BN running statistics (buffers here), as
        the JAX package counts them."""
        return sum(p.numel() for p in self.parameters())

    def logmel_bn0(self, waveform: torch.Tensor,
                   mixup_lambda: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, int]:
        """Log-mel (B, 1, T, M) with bn0 over the mel axis, and T; in a
        training forward then SpecAugment and mixup (unless the config mixes
        the waveform) (the JAX package's ``_frontend_bn0``, :107-124)."""
        spec = self.frontend(waveform)
        x = self.bn0(spec, axis=3)
        ctx = P.train_ctx()
        if ctx is not None:
            if self.cfg.use_spec_augment:
                x = ctx.spec_augment(x, 2, 3, self.cfg.spec_augment)
            if mixup_lambda is not None and not self.cfg.mixup_on_waveform:
                x = do_mixup(x, mixup_lambda)
        return x, spec.shape[2]

    def head(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, C) pooled features -> dropout -> relu(fc1) -> logits; the
        embedding is relu(fc1) after a second dropout, which the logits do
        not see (models.py:2170-2177)."""
        x = P.dropout(x, self.cfg.head_dropout)
        if hasattr(self, "fc1"):
            x = F.relu(self.fc1(x))
        embedding = P.dropout(x, self.cfg.head_dropout)
        logits = self.fc_audioset(x)
        return {"clipwise_output": torch.sigmoid(logits), "clipwise_logits": logits,
                "embedding": embedding}

    def pool_head(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, C, T, F): freq mean, time max + mean, ``head``
        (models.py:2167-2177)."""
        x = torch.mean(x, dim=3)
        return self.head(torch.amax(x, dim=2) + torch.mean(x, dim=2))

    def serve_frontend(self, waveform: torch.Tensor) -> torch.Tensor:
        """The serving route's log-mel (B, 1, T, M) with bn0 folded in as a
        per-bin f32 affine, in bf16, channels last."""
        with span("model.frontend"):
            x = self.frontend(waveform, affine=self.bn0.fold(1e-5))
            return P.to_serve_layout(x.to(self.compute_dtype))

    def serve_head(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``pool_head`` on the serving route: the reductions in f32 over
        the bf16 map, ``fc1`` with bf16 operands and f32 accumulation,
        ``fc_audioset`` and the sigmoid in true f32."""
        with span("model.head"):
            x = x.float().mean(dim=3)
            x = torch.amax(x, dim=2) + torch.mean(x, dim=2)
            x = F.relu(mm_f32acc(x.to(self.compute_dtype), self.fc1.weight.t().to(
                self.compute_dtype)) + self.fc1.bias.float())
            with fp32_precision("highest"):
                logits = self.fc_audioset(x)
            return {"clipwise_output": torch.sigmoid(logits), "clipwise_logits": logits,
                    "embedding": x}

    def pool_head_1d(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, C, L): time max + mean, ``head`` (models.py:4348)."""
        return self.head(torch.amax(x, dim=2) + torch.mean(x, dim=2))


# CNN family (Cnn6/Cnn10/Cnn14 + emb/mel/sr/ablation variants)

_BLOCKS = {"conv": P.ConvBlock, "conv5x5": P.ConvBlock5x5, "sep": P.ConvBlockSep,
           "seppw": P.ConvBlockSepPW}


class Cnn(PannModel):
    def build(self, cfg: PannConfig) -> None:
        self.bn0 = P.BatchNorm(cfg.frontend.n_mels)
        in_ch = 1
        for i, out_ch in enumerate(cfg.channels):
            if (i + 1) in cfg.deformable_blocks:
                blk = P.ConvBlockDeformable(in_ch, out_ch, 5 if cfg.block == "conv5x5" else 3)
            else:
                blk = _BLOCKS[cfg.block](in_ch, out_ch)
            setattr(self, f"conv_block{i + 1}", blk)
            in_ch = out_ch
        fc1_out = cfg.fc1_out or in_ch
        self.fc1 = P.linear(in_ch, fc1_out)
        self.build_classifier(cfg, fc1_out)

    def build_classifier(self, cfg: PannConfig, dim: int) -> None:
        self.fc_audioset = P.linear(dim, cfg.classes_num)

    def trunk(self, waveform: torch.Tensor,
              mixup_lambda: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, int]:
        """The conv blocks over the log-mel, each followed by dropout:
        (B, C, T', F') and T. Cnn14 pools (2, 2) after blocks 1-5 and not
        after block 6; the 4-block Cnn6/Cnn10 pool after every block
        (models.py:2154-2165, 2836-2844). Cnn14_mixup_time_domain mixes the
        waveform (models.py:5402)."""
        if P.train_ctx() is not None and self.cfg.mixup_on_waveform and mixup_lambda is not None:
            waveform = do_mixup(waveform, mixup_lambda)
        x, frames_num = self.logmel_bn0(waveform, mixup_lambda)
        n = len(self.cfg.channels)
        for i in range(n):
            pool = (1, 1) if (n == 6 and i == n - 1) else (2, 2)
            x = getattr(self, f"conv_block{i + 1}")(x, pool, "avg")
            x = P.dropout(x, self.cfg.block_dropout)
        return x, frames_num

    def compute(self, waveform, mixup_lambda=None):
        return self.pool_head(self.trunk(waveform, mixup_lambda)[0])

    def serve(self, waveform):
        x = self.serve_frontend(waveform)
        n = len(self.cfg.channels)
        with span("model.trunk"):
            for i in range(n):
                pool = (1, 1) if (n == 6 and i == n - 1) else (2, 2)
                x = getattr(self, f"conv_block{i + 1}").serve(x, pool)
        return self.serve_head(x)


class Sed(Cnn):
    """Decision-level heads on the Cnn14 trunk (models.py:5678-5982): a
    per-segment classifier, max / avg / attention over time, and the
    segments repeated and padded to the log-mel's frame count."""

    def build_classifier(self, cfg: PannConfig, dim: int) -> None:
        if cfg.sed_head == "att":
            self.att_block = P.AttBlock(dim, cfg.classes_num)
        else:
            super().build_classifier(cfg, dim)

    def compute(self, waveform, mixup_lambda=None):
        x, frames_num = self.trunk(waveform, mixup_lambda)
        x = torch.mean(x, dim=3)  # (B, C, T')
        # local smoothing over time: max + avg pool, k3 s1 p1
        x = P.pool1d(x, 3, 1, 1, "max") + P.pool1d(x, 3, 1, 1, "avg")
        x = F.relu(self.fc1(P.dropout(x, 0.5).transpose(1, 2)))  # (B, T', fc1)
        x = P.dropout(x, 0.5, channel_dim=2)
        if self.cfg.sed_head == "att":
            clipwise, _, cla = self.att_block(x.transpose(1, 2))
            segmentwise = cla.transpose(1, 2)
        else:
            segmentwise = torch.sigmoid(self.fc_audioset(x))
            if self.cfg.sed_head == "max":
                clipwise = torch.amax(segmentwise, dim=1)
            else:
                clipwise = torch.mean(segmentwise, dim=1)
        framewise = P.interpolate_time(segmentwise, self.cfg.interpolate_ratio)
        return {"framewise_output": P.pad_framewise_output(framewise, frames_num),
                "segmentwise_output": segmentwise, "clipwise_output": clipwise}


# CNN-with-ConvNeXt-block hybrids (models.py:268-1876, the paper's ablation
# ladder between PANN CNNs and ConvNeXt)


class NextBlock(nn.Module):
    """models.py Block:61-128 / BlockGroup1:132-200: layer scale 0 (no
    gamma) and the residual commented out, so non-residual: grouped dwconv
    (in -> out, or in -> in for BlockGroup1), LN, pwconv MLP with erf GELU,
    then a pool or a [LN, 2x2 stride-2 conv] downsample."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, group1: bool, pool: str):
        super().__init__()
        dim = in_ch if group1 else out_ch
        self.dwconv = P.conv2d(in_ch, dim, kernel, padding=kernel // 2, groups=in_ch, bias=True)
        self.norm = LayerNorm(dim, 1e-6)
        self.pwconv1 = P.linear(dim, 4 * dim)
        self.pwconv2 = P.linear(4 * dim, dim)
        if pool == "conv":
            self.downsample_layer = nn.Sequential(
                P.LayerNorm2d(dim, 1e-6),
                P.conv2d(dim, out_ch, 2, stride=2, bias=True))
        self.pool = pool

    def forward(self, x):
        x = self.dwconv(x).permute(0, 2, 3, 1)
        x = self.pwconv2(L.gelu(self.pwconv1(self.norm(x)))).permute(0, 3, 1, 2)
        if self.pool == "conv":
            return self.downsample_layer(x)
        return P.pool2d(x, (2, 2), self.pool)


class CnnNext(PannModel):
    def build(self, cfg: PannConfig) -> None:
        self.bn0 = P.BatchNorm(cfg.frontend.n_mels)
        if cfg.next_stem:
            self.stem = nn.Sequential(P.conv2d(1, 64, 4, stride=2, bias=True),
                                      P.LayerNorm2d(64, 1e-6))
        for i, (c_in, c_out, k, pool) in enumerate(cfg.next_blocks):
            setattr(self, f"conv_block{i + 1}", NextBlock(c_in, c_out, k, cfg.next_group1, pool))
        feat = cfg.next_blocks[-1][1]
        if cfg.use_fc1:
            self.fc1 = P.linear(feat, cfg.fc1_out or feat)
            feat = cfg.fc1_out or feat
        self.fc_audioset = P.linear(feat, cfg.classes_num)

    def compute(self, waveform, mixup_lambda=None):
        x, _ = self.logmel_bn0(waveform, mixup_lambda)
        if self.cfg.next_stem:
            x = self.stem(x)
        for i in range(len(self.cfg.next_blocks)):
            x = P.dropout(getattr(self, f"conv_block{i + 1}")(x), self.cfg.block_dropout)
        return self.pool_head(x)


# ResNet family (models.py:3437-3697)


class ResNet(PannModel):
    def build(self, cfg: PannConfig) -> None:
        expansion = 1 if cfg.resnet_block == "basic" else 4
        self.bn0 = P.BatchNorm(cfg.frontend.n_mels)
        self.conv_block1 = P.ConvBlock(1, 64)
        self.resnet = P.Resnet(cfg.resnet_block, cfg.resnet_layers)
        self.conv_block_after1 = P.ConvBlock(512 * expansion, 2048)
        self.fc1 = P.linear(2048, 2048)
        self.fc_audioset = P.linear(2048, cfg.classes_num)

    def compute(self, waveform, mixup_lambda=None):
        x, _ = self.logmel_bn0(waveform, mixup_lambda)
        x = P.dropout(self.conv_block1(x, (2, 2), "avg"), 0.2)
        x = P.dropout(P.pool2d(self.resnet(x), (2, 2), "avg"), 0.2)
        x = P.dropout(self.conv_block_after1(x, (1, 1), "avg"), 0.2)
        return self.pool_head(x)


# MobileNet V1/V2 (models.py:3971-4268)

_MBV1_LADDER = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2), (256, 256, 1),
                (256, 512, 2), (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
                (512, 512, 1), (512, 1024, 2), (1024, 1024, 1)]

_MBV2_SETTING = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                 (6, 96, 3, 2), (6, 160, 3, 1), (6, 320, 1, 1)]


def mbv2_block_meta() -> List[Tuple[int, int]]:
    """(expand ratio, stride) of each MobileNetV2 block, in order."""
    return [(t, s if i == 0 else 1) for t, _, n, s in _MBV2_SETTING for i in range(n)]


class MobileNetV1(PannModel):
    def build(self, cfg: PannConfig) -> None:
        self.bn0 = P.BatchNorm(cfg.frontend.n_mels)
        self.features = nn.Sequential(P.mb_conv_bn(1, 32, 2),
                                      *[P.mb_conv_dw(i, o, s) for i, o, s in _MBV1_LADDER])
        self.fc1 = P.linear(1024, 1024)
        self.fc_audioset = P.linear(1024, cfg.classes_num)

    def compute(self, waveform, mixup_lambda=None):
        return self.pool_head(self.features(self.logmel_bn0(waveform, mixup_lambda)[0]))


class MobileNetV2(PannModel):
    def build(self, cfg: PannConfig) -> None:
        self.bn0 = P.BatchNorm(cfg.frontend.n_mels)
        blocks, in_ch = [], 32
        for t, c, n, s in _MBV2_SETTING:
            for i in range(n):
                blocks.append(P.InvertedResidual(in_ch, c, s if i == 0 else 1, t))
                in_ch = c
        self.features = nn.Sequential(
            P.mb_conv_bn(1, 32, 2), *blocks,
            nn.Sequential(P.conv2d(in_ch, 1280, 1), P.BatchNorm(1280), nn.ReLU6()))
        self.fc1 = P.linear(1280, 1024)
        self.fc_audioset = P.linear(1024, cfg.classes_num)

    def compute(self, waveform, mixup_lambda=None):
        return self.pool_head(self.features(self.logmel_bn0(waveform, mixup_lambda)[0]))


def _mix_input(x: torch.Tensor, mixup_lambda: Optional[torch.Tensor]) -> torch.Tensor:
    """A raw-waveform family's input (B, 1, samples), mixed in a training
    forward (models.py:4330, the JAX package's :513, :550, :578)."""
    if P.train_ctx() is not None and mixup_lambda is not None:
        return do_mixup(x, mixup_lambda)
    return x


# Raw-waveform 1-D families


class LeeNet(PannModel):
    def build(self, cfg: PannConfig) -> None:
        block = P.LeeBlock2 if cfg.lee_double else P.LeeBlock
        in_ch = 1
        for i, out_ch in enumerate(cfg.lee_channels):
            setattr(self, f"conv_block{i + 1}", block(in_ch, out_ch, 3, 3 if i == 0 else 1))
            in_ch = out_ch
        self.fc1 = P.linear(in_ch, cfg.fc1_out or in_ch)
        self.fc_audioset = P.linear(cfg.fc1_out or in_ch, cfg.classes_num)

    def compute(self, waveform, mixup_lambda=None):
        x = _mix_input(waveform[:, None, :], mixup_lambda)
        last = len(self.cfg.lee_channels) - 1
        for i in range(last + 1):
            pool = 1 if i == 0 or (self.cfg.lee_double and i == last) else 3
            x = getattr(self, f"conv_block{i + 1}")(x, pool)
            # LeeNet24 drops between blocks, not after the last (models.py:4406-4442)
            if self.cfg.lee_double and i < last:
                x = P.dropout(x, 0.1)
        return self.pool_head_1d(x)


_DAI_LADDER = [(64, 64), (64, 128), (128, 256), (256, 512)]


class DaiNet(PannModel):
    def build(self, cfg: PannConfig) -> None:
        self.conv0 = P.conv1d(1, 64, 80, stride=4)
        self.bn0 = P.BatchNorm(64)
        for i, (c_in, c_out) in enumerate(_DAI_LADDER):
            setattr(self, f"conv_block{i + 1}", P.DaiBlock(c_in, c_out, 3))
        self.fc1 = P.linear(512, 512)
        self.fc_audioset = P.linear(512, cfg.classes_num)

    def compute(self, waveform, mixup_lambda=None):
        x = self.bn0(self.conv0(_mix_input(waveform[:, None, :], mixup_lambda)))
        # the reference pools between blocks 1-4 (padding 0), not after the
        # last (models.py:4560-4570)
        for i in range(len(_DAI_LADDER)):
            x = getattr(self, f"conv_block{i + 1}")(x)
            if i < len(_DAI_LADDER) - 1:
                x = P.pool1d(x, 4)
        return self.pool_head_1d(x)


class Res1dNet(PannModel):
    def build(self, cfg: PannConfig) -> None:
        self.conv0 = P.conv1d(1, 64, 11, padding=5, stride=5)
        self.bn0 = P.BatchNorm(64)
        self.resnet = P.Res1dNet(cfg.res1d_layers)
        self.fc1 = P.linear(2048, 2048)
        self.fc_audioset = P.linear(2048, cfg.classes_num)

    def compute(self, waveform, mixup_lambda=None):
        x = self.bn0(self.conv0(_mix_input(waveform[:, None, :], mixup_lambda)))
        return self.pool_head_1d(self.resnet(x))


# Wavegram family (models.py:4892-5205)


def _wavegram_groups(cfg: PannConfig) -> int:
    """Freq-group count of the wavegram reshape: 32 normally, 64 for the
    128-mel variant so widths align for the concat (models.py:4949, 5171)."""
    return 64 if (cfg.wavegram_logmel and cfg.frontend.n_mels == 128) else 32


class Wavegram(PannModel):
    def build(self, cfg: PannConfig) -> None:
        self.pre_conv0 = P.conv1d(1, 64, 11, padding=5, stride=5)
        self.pre_bn0 = P.BatchNorm(64)
        self.pre_block1 = P.PreWavBlock(64, 64)
        self.pre_block2 = P.PreWavBlock(64, 128)
        # pre_block3 yields 4 channels after the freq-group reshape
        self.pre_block3 = P.PreWavBlock(128, 4 * _wavegram_groups(cfg))
        self.pre_block4 = P.ConvBlock(4, 64)
        if cfg.wavegram_logmel:
            self.bn0 = P.BatchNorm(cfg.frontend.n_mels)
            self.conv_block1 = P.ConvBlock(1, 64)
            self.conv_block2 = P.ConvBlock(128, 128)
        else:
            self.conv_block1 = P.ConvBlock(1, 64)  # unused; the reference has it
            self.conv_block2 = P.ConvBlock(64, 128)
            self.bn0 = P.BatchNorm(64)
        channels = (64, 128, 256, 512, 1024, 2048)
        for i in range(3, 7):
            setattr(self, f"conv_block{i}", P.ConvBlock(channels[i - 2], channels[i - 1]))
        self.fc1 = P.linear(2048, 2048)
        self.fc_audioset = P.linear(2048, cfg.classes_num)

    def wavegram(self, waveform: torch.Tensor) -> torch.Tensor:
        """The 1-D path as a 2-D map (B, 4, T, g) (models.py:4945-4951)."""
        a = F.relu(self.pre_bn0(self.pre_conv0(waveform[:, None, :])))
        for blk in (self.pre_block1, self.pre_block2, self.pre_block3):
            a = blk(a, 4)
        b, c, t = a.shape
        g = _wavegram_groups(self.cfg)
        a = a.reshape(b, c // g, g, t).transpose(2, 3)  # freq = the group axis
        return self.pre_block4(a, (2, 1), "avg")

    def compute(self, waveform, mixup_lambda=None):
        with span("model.wavegram"):
            x = self.wavegram(waveform)
        if P.train_ctx() is not None and mixup_lambda is not None:
            x = do_mixup(x, mixup_lambda)  # beside the log-mel's mixup
        if self.cfg.wavegram_logmel:
            with span("model.frontend"):
                spec, _ = self.logmel_bn0(waveform, mixup_lambda)
            with span("model.trunk"):
                spec = self.conv_block1(spec, (2, 2), "avg")
                x = _concat(spec, x)
        with span("model.trunk"):
            x = P.dropout(x, 0.2)
            for i in range(2, 7):
                x = getattr(self, f"conv_block{i}")(x, (2, 2) if i < 6 else (1, 1), "avg")
                x = P.dropout(x, 0.2)
        with span("model.head"):
            return self.pool_head(x)

    def serve(self, waveform):
        if self.cfg.wavegram_logmel:
            spec = self.serve_frontend(waveform)
        with span("model.wavegram"):
            a = waveform.to(self.compute_dtype)[:, None, None, :]
            a = P.conv_bn_relu(P.to_serve_layout(a), self.pre_conv0, self.pre_bn0)
            for blk in (self.pre_block1, self.pre_block2, self.pre_block3):
                a = blk.serve(a, 4)
            b, c, _, t = a.shape
            g = _wavegram_groups(self.cfg)
            a = a.reshape(b, c // g, g, t).transpose(2, 3)
            x = self.pre_block4.serve(P.to_serve_layout(a), (2, 1))
        with span("model.trunk"):
            if self.cfg.wavegram_logmel:
                x = _concat(self.conv_block1.serve(spec, (2, 2)), x)
            for i in range(2, 7):
                x = getattr(self, f"conv_block{i}").serve(x, (2, 2) if i < 6 else (1, 1))
        return self.serve_head(x)


def _concat(spec: torch.Tensor, wave: torch.Tensor) -> torch.Tensor:
    """The log-mel and wavegram maps side by side on the channel axis, over
    the shorter time axis, the wavegram's freq axis cut to the log-mel's."""
    t = min(spec.shape[2], wave.shape[2])
    return torch.cat([spec[:, :, :t], wave[:, :, :t, : spec.shape[3]]], dim=1)


# ---------------------------------------------------------------------------
# Registry and factory
# ---------------------------------------------------------------------------

_FAMILIES: Dict[str, type] = {
    "cnn": Cnn, "cnn_next": CnnNext, "sed": Sed, "resnet": ResNet,
    "mobilenet_v1": MobileNetV1, "mobilenet_v2": MobileNetV2, "leenet": LeeNet,
    "dainet": DaiNet, "res1dnet": Res1dNet, "wavegram": Wavegram,
}


def _cnn14(name, **kw):
    kw.setdefault("family", "cnn")
    kw.setdefault("channels", (64, 128, 256, 512, 1024, 2048))
    return PannConfig(name=name, **kw)


PANN_REGISTRY: Dict[str, PannConfig] = {
    # PANN CNNs (models.py:2090,2773,3150)
    "Cnn14": _cnn14("Cnn14"),
    "Cnn14Sep": _cnn14("Cnn14Sep", block="sep"),
    "Cnn14SepPW": _cnn14("Cnn14SepPW", block="seppw"),
    # the reference's default is deformable=None (== plain); registered with
    # the last two blocks deformable so the gather+matmul path is exercised
    "Cnn14Deformable": _cnn14("Cnn14Deformable", deformable_blocks=(5, 6)),
    "Cnn6Deformable": PannConfig(name="Cnn6Deformable", family="cnn",
                                 channels=(64, 128, 256, 512), block="conv5x5",
                                 deformable_blocks=(3, 4)),
    "Cnn6": PannConfig(name="Cnn6", family="cnn", channels=(64, 128, 256, 512), block="conv5x5"),
    "Cnn10": PannConfig(name="Cnn10", family="cnn", channels=(64, 128, 256, 512)),
    # ablations (models.py:2604,2688,5402)
    "Cnn14_no_specaug": _cnn14("Cnn14_no_specaug", use_spec_augment=False),
    "Cnn14_no_dropout": _cnn14("Cnn14_no_dropout", block_dropout=0.0, head_dropout=0.0),
    "Cnn14_mixup_time_domain": _cnn14("Cnn14_mixup_time_domain", mixup_on_waveform=True),
    # embedding-size variants (models.py:3698-3968)
    "Cnn14_emb512": _cnn14("Cnn14_emb512", fc1_out=512),
    "Cnn14_emb128": _cnn14("Cnn14_emb128", fc1_out=128),
    "Cnn14_emb32": _cnn14("Cnn14_emb32", fc1_out=32),
    # sample-rate / mel variants (models.py:5208-5676)
    "Cnn14_16k": _cnn14("Cnn14_16k", frontend=FRONTEND_16K),
    "Cnn14_8k": _cnn14("Cnn14_8k", frontend=FRONTEND_8K),
    "Cnn14_mel32": _cnn14("Cnn14_mel32", frontend=replace(PANN_FRONTEND, n_mels=32)),
    "Cnn14_mel128": _cnn14("Cnn14_mel128", frontend=replace(PANN_FRONTEND, n_mels=128)),
    # SED decision-level heads (models.py:5678-5982)
    "Cnn14_DecisionLevelMax": _cnn14("Cnn14_DecisionLevelMax", family="sed", sed_head="max"),
    "Cnn14_DecisionLevelAvg": _cnn14("Cnn14_DecisionLevelAvg", family="sed", sed_head="avg"),
    "Cnn14_DecisionLevelAtt": _cnn14("Cnn14_DecisionLevelAtt", family="sed", sed_head="att"),
    # ResNets (models.py:3437-3697)
    "ResNet22": PannConfig(name="ResNet22", family="resnet", resnet_layers=(2, 2, 2, 2)),
    "ResNet38": PannConfig(name="ResNet38", family="resnet", resnet_layers=(3, 4, 6, 3)),
    "ResNet54": PannConfig(name="ResNet54", family="resnet", resnet_block="bottleneck",
                           resnet_layers=(3, 4, 6, 3)),
    # MobileNets (models.py:3971-4268)
    "MobileNetV1": PannConfig(name="MobileNetV1", family="mobilenet_v1"),
    "MobileNetV2": PannConfig(name="MobileNetV2", family="mobilenet_v2"),
    # raw-waveform models (models.py:4296-4853)
    "LeeNet11": PannConfig(name="LeeNet11", family="leenet", fc1_out=512),
    "LeeNet24": PannConfig(name="LeeNet24", family="leenet", lee_double=True,
                           lee_channels=(64, 96, 128, 128, 256, 256, 512, 512, 1024)),
    "DaiNet19": PannConfig(name="DaiNet19", family="dainet"),
    "Res1dNet31": PannConfig(name="Res1dNet31", family="res1dnet",
                             res1d_layers=(2, 2, 2, 2, 2, 2, 2)),
    "Res1dNet51": PannConfig(name="Res1dNet51", family="res1dnet",
                             res1d_layers=(2, 3, 4, 6, 4, 3, 2)),
    # CNN-with-ConvNeXt-block hybrids (models.py:268-1876). Ladders read
    # from each class's __init__/forward; Cnn7Next's head is fixed (the
    # reference overwrites fc_audioset with a shape-incompatible layer).
    **{
        name: PannConfig(name=name, family="cnn_next", **kw)  # type: ignore[arg-type]
        for name, kw in {
            "Cnn6Next": dict(next_blocks=((64, 128, 7, "avg"), (128, 256, 7, "avg"), (256, 512, 7, "avg"))),
            "Cnn6Next11": dict(next_blocks=((64, 128, 11, "avg"), (128, 256, 11, "avg"), (256, 512, 11, "avg"))),
            "Cnn6Next13": dict(next_blocks=((64, 128, 13, "avg"), (128, 256, 13, "avg"), (256, 512, 13, "avg"))),
            "Cnn6NextNoLastPool": dict(next_blocks=((64, 128, 7, "avg"), (128, 256, 7, "avg"), (256, 512, 7, "no"))),
            "Cnn6NextConvPool": dict(next_blocks=((64, 128, 7, "conv"), (128, 256, 7, "conv"), (256, 512, 7, "conv"))),
            "Cnn6NextConvPoolGroup1": dict(
                next_blocks=((64, 128, 7, "conv"), (128, 256, 7, "conv"), (256, 512, 7, "conv")),
                next_group1=True),
            "Cnn6NextNoStem": dict(
                next_stem=False,
                next_blocks=((1, 64, 7, "avg"), (64, 128, 7, "avg"), (128, 256, 7, "avg"), (256, 512, 7, "no"))),
            "Cnn6Next11NoStem": dict(
                next_stem=False,
                next_blocks=((1, 64, 11, "avg"), (64, 128, 11, "avg"), (128, 256, 11, "avg"), (256, 512, 11, "no"))),
            "Cnn6Next13NoStem": dict(
                next_stem=False,
                next_blocks=((1, 64, 13, "avg"), (64, 128, 13, "avg"), (128, 256, 13, "avg"), (256, 512, 13, "no"))),
            "Cnn7Next": dict(
                next_stem=False, fc1_out=512,
                next_blocks=((1, 64, 7, "avg"), (64, 128, 7, "avg"), (128, 256, 7, "avg"),
                             (256, 512, 7, "avg"), (512, 1024, 7, "no"))),
            "Cnn8NextNoStemNoFC1": dict(
                next_stem=False, use_fc1=False,
                next_blocks=((1, 64, 7, "avg"), (64, 128, 7, "avg"), (128, 256, 7, "avg"),
                             (256, 512, 7, "avg"), (512, 1024, 7, "avg"), (1024, 2048, 7, "no"))),
            "Cnn10Next": dict(
                next_blocks=((64, 128, 7, "no"), (128, 128, 7, "avg"), (128, 256, 7, "no"),
                             (256, 256, 7, "avg"), (256, 512, 7, "no"), (512, 512, 7, "no"))),
            "Cnn10Next11": dict(
                next_blocks=((64, 128, 11, "no"), (128, 128, 11, "avg"), (128, 256, 11, "no"),
                             (256, 256, 11, "avg"), (256, 512, 11, "no"), (512, 512, 11, "no"))),
            "Cnn10NextNoStem": dict(
                next_stem=False,
                next_blocks=((1, 64, 7, "no"), (64, 128, 7, "no"), (128, 128, 7, "avg"),
                             (128, 256, 7, "no"), (256, 256, 7, "avg"), (256, 512, 7, "no"),
                             (512, 512, 7, "no"))),
            "Cnn10NextDropPath": dict(
                block_dropout=0.0,
                next_blocks=((64, 128, 7, "no"), (128, 128, 7, "avg"), (128, 256, 7, "no"),
                             (256, 256, 7, "avg"), (256, 512, 7, "no"), (512, 512, 7, "no"))),
            "Cnn14Next": dict(
                next_blocks=((64, 128, 7, "no"), (128, 128, 7, "avg"), (128, 256, 7, "no"),
                             (256, 256, 7, "avg"), (256, 512, 7, "no"), (512, 512, 7, "avg"),
                             (512, 1024, 7, "no"), (1024, 1024, 7, "avg"), (1024, 2048, 7, "no"),
                             (2048, 2048, 7, "no"))),
        }.items()
    },
    # Wavegram hybrids (models.py:4892-5205)
    "Wavegram_Cnn14": PannConfig(name="Wavegram_Cnn14", family="wavegram"),
    "Wavegram_Logmel_Cnn14": PannConfig(name="Wavegram_Logmel_Cnn14", family="wavegram",
                                        wavegram_logmel=True),
    "Wavegram_Logmel128_Cnn14": PannConfig(
        name="Wavegram_Logmel128_Cnn14", family="wavegram", wavegram_logmel=True,
        frontend=replace(PANN_FRONTEND, n_mels=128)),
}


def serves_bf16(cfg: PannConfig) -> bool:
    """Whether ``cfg``'s family has the bf16 serving route: the wavegram
    family, and the cnn family with its plain double-3x3 ``ConvBlock``s
    (Cnn14, Cnn10 and their variants)."""
    return cfg.family == "wavegram" or (
        cfg.family == "cnn" and cfg.block == "conv" and not cfg.deformable_blocks)


def build_pann_model(cfg: PannConfig, seed: int = 0, device=None,
                     compute_dtype=torch.float32) -> PannModel:
    """The family's model for ``cfg`` (a registry entry or a variant of one)."""
    return _FAMILIES[cfg.family](cfg, device=device, seed=seed, compute_dtype=compute_dtype)


def create_pann_model(name: str, seed: int = 0, device=None,
                      compute_dtype=torch.float32) -> PannModel:
    """A zoo model by reference class name (the safe analog of main.py's
    ``eval(model_type)`` dispatch), on the card unless ``device`` says;
    ``compute_dtype`` as ``PannModel`` takes it."""
    if name not in PANN_REGISTRY:
        raise KeyError(f"unknown PANN model {name!r}; available: {sorted(PANN_REGISTRY)}")
    return build_pann_model(PANN_REGISTRY[name], seed, device, compute_dtype)
