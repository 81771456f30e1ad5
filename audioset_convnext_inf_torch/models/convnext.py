"""ConvNeXt audio-tagging trunk of the PyTorch port: eval and training.

The modules hold the parameters under the reference's state-dict names
(pytorch/convnext.py:145-261), so a reference checkpoint loads with
``load_state_dict(strict=True)``:

    bn0.{weight,bias,running_mean,running_var}
    downsample_layers.0.{0: stem conv, 1: LN}
    downsample_layers.{1,2,3}.{0: LN, 1: 2x2 conv}
    stages.i.j.{dwconv,norm,pwconv1,pwconv2,gamma}
    norm, head_audioset

The forward functions mirror the JAX package's ``models/convnext.py``
function for function and keep its rounding points. Activations are NHWC
(B, H, W, C) throughout. With ``block_impl="xla_approx"`` at eval, every
block of stages 3 and 4 runs the fused block kernel (``ops/fused_block.py``);
the other blocks run ``_block_apply`` in plain PyTorch. In training mode
(``model.training``) with ``fused_train_blocks``, those blocks run
``FusedBlockTrain``: the fused kernel's save mode forward and the fused
backward kernel (``ops/fused_block_bwd.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from audioset_convnext_inf_torch.config import ConvNeXtConfig
from audioset_convnext_inf_torch.models import layers as L
from audioset_convnext_inf_torch.ops import augment as A
from audioset_convnext_inf_torch.ops.frontend import LogMelFrontend
from audioset_convnext_inf_torch.ops.fused_block import fused_block
from audioset_convnext_inf_torch.ops.fused_block_train import FusedBlockTrain
from audioset_convnext_inf_torch.ops.mixup import do_mixup
from audioset_convnext_inf_torch.ops.specaugment import draw_stripes, spec_augment

# Stage indices whose blocks run the fused kernel in the bf16 serving
# config: the JAX package's set (its _FUSED_STAGE_TILES keys). The fused and
# unfused blocks round bf16 at different points, so this set is part of what
# bf16 parity with the JAX package means.
FUSED_STAGES = (2, 3)


class BatchNorm0(nn.Module):
    """bn0 over the mel axis: exactly the four reference entries (no
    ``num_batches_tracked``, which the carried weights lack). Training
    updates the running statistics in place (``layers.batch_norm_train``)."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def fold(self, eps: float):
        """(a, b) in f32 with bn0(x) = a*x + b."""
        a = self.weight.float() * torch.rsqrt(self.running_var.float() + eps)
        return a, self.bias.float() - a * self.running_mean.float()


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.layer_norm(x, self.weight, self.bias, self.eps)


class Block(nn.Module):
    """ConvNeXt block parameters (reference convnext.py:58-87)."""

    def __init__(self, dim: int, eps: float, layer_scale: float):
        super().__init__()
        self.dwconv = nn.utils.skip_init(nn.Conv2d, dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps)
        self.pwconv1 = nn.utils.skip_init(nn.Linear, dim, 4 * dim)
        self.pwconv2 = nn.utils.skip_init(nn.Linear, 4 * dim, dim)
        if layer_scale > 0:
            self.gamma = nn.Parameter(layer_scale * torch.ones(dim))
        else:
            self.register_parameter("gamma", None)


class ConvNeXtModule(nn.Module):
    """Parameters of the audio ConvNeXt, randomly initialized from ``seed``
    on the CPU (so a seed gives the same weights on every device), then
    moved to ``device``."""

    def __init__(self, cfg: ConvNeXtConfig, device="cpu", seed: int = 0):
        super().__init__()
        dims = cfg.dims
        (kh, kw), stride, pad = cfg.stem_geometry()
        self.bn0 = BatchNorm0(cfg.frontend.n_mels)
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.utils.skip_init(nn.Conv2d, cfg.in_chans, dims[0], (kh, kw), stride, pad),
            LayerNorm(dims[0], cfg.ln_eps),
        )])
        for i in range(3):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm(dims[i], cfg.ln_eps),
                nn.utils.skip_init(nn.Conv2d, dims[i], dims[i + 1], 2, 2),
            ))
        self.stages = nn.ModuleList(
            nn.Sequential(*[Block(dims[i], cfg.ln_eps, cfg.layer_scale_init_value)
                            for _ in range(depth)])
            for i, depth in enumerate(cfg.depths)
        )
        self.norm = LayerNorm(dims[-1], cfg.ln_eps)
        self.head_audioset = nn.utils.skip_init(nn.Linear, dims[-1], cfg.num_classes)
        init_params_(self, cfg, torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()


@torch.no_grad()
def init_params_(model: ConvNeXtModule, cfg: ConvNeXtConfig, gen: torch.Generator) -> None:
    """The reference recipe (trunc_normal std=0.02 for conv/linear weights,
    zero biases); draws in the JAX package's key order. The numbers differ
    from the JAX package's: tests carry weights across instead."""
    L.init_conv_(model.downsample_layers[0][0], gen)
    for i in range(1, 4):
        L.init_conv_(model.downsample_layers[i][1], gen)
    L.init_linear_(model.head_audioset, gen)
    for stage in model.stages:
        for blk in stage:
            L.init_conv_(blk.dwconv, gen)
            L.init_linear_(blk.pwconv1, gen)
            L.init_linear_(blk.pwconv2, gen)
    if cfg.head_init_scale != 1.0:
        model.head_audioset.weight.mul_(cfg.head_init_scale)
        model.head_audioset.bias.mul_(cfg.head_init_scale)


class Shard(NamedTuple):
    """One process's part of a data-parallel training step. ``rows`` are its
    rows of the global input batch of ``total`` (2B with mixup);
    ``all_reduce`` averages a list of tensors over the processes in place
    and returns their number (bn0's global statistics). Draws that depend on the batch are made for the
    global batch and sliced to ``rows``, except drop path when
    ``drop_path_generator`` is given: it then draws for these rows alone."""

    rows: slice
    total: int
    all_reduce: Callable[[List[torch.Tensor]], int]
    drop_path_generator: Optional[torch.Generator] = None


def count_parameters(model: nn.Module) -> int:
    """Trainable parameter count; bn0's running stats are buffers and do not
    count (the reference's ``count_parameters``)."""
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _block_apply(x: torch.Tensor, blk: Block, block_impl: str = "xla",
                 drop_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ConvNeXt block in plain PyTorch: erf GELU under "xla", tanh under
    "xla_approx"; ``drop_scale`` (B,) is the block's drop-path draw."""
    shortcut = x
    c = x.shape[-1]
    x = L.conv2d(x, blk.dwconv.weight, blk.dwconv.bias, padding=(3, 3), groups=c)
    x = blk.norm(x)
    x = L.linear(x, blk.pwconv1.weight, blk.pwconv1.bias)
    x = torch.nn.functional.gelu(x, approximate="tanh" if block_impl == "xla_approx" else "none")
    x = L.linear(x, blk.pwconv2.weight, blk.pwconv2.bias)
    if blk.gamma is not None:
        x = x * blk.gamma.to(x.dtype)
    return shortcut + L.drop_path(x, drop_scale)


def _fused_block(x: torch.Tensor, blk: Block) -> torch.Tensor:
    return fused_block(
        x.contiguous(), blk.dwconv.weight, blk.dwconv.bias,
        blk.norm.weight, blk.norm.bias,
        blk.pwconv1.weight, blk.pwconv1.bias,
        blk.pwconv2.weight, blk.pwconv2.bias,
        blk.gamma, blk.norm.eps,
    )


def _fused_block_train(x: torch.Tensor, blk: Block, s: Optional[torch.Tensor]) -> torch.Tensor:
    if s is not None:
        s = s.to(device=x.device, dtype=torch.float32)
    return FusedBlockTrain.apply(
        x.contiguous(), blk.dwconv.weight, blk.dwconv.bias, blk.norm.weight, blk.norm.bias,
        blk.pwconv1.weight, blk.pwconv1.bias, blk.pwconv2.weight, blk.pwconv2.bias,
        blk.gamma, s, blk.norm.eps)


def draw_drop_path_scales(generator: Optional[torch.Generator], batch: int,
                          cfg: ConvNeXtConfig) -> List[Optional[torch.Tensor]]:
    """One drop-path draw per block (``layers.draw_drop_path``), at the rates
    linspace(0, drop_path_rate, sum(depths)); None for a rate of 0."""
    rates = np.linspace(0.0, cfg.drop_path_rate, sum(cfg.depths))
    return [L.draw_drop_path(generator, batch, float(r)) for r in rates]


def fused_train_route(model: nn.Module, cfg: ConvNeXtConfig) -> bool:
    """Whether training runs stages 3-4 through the fused training block:
    the JAX package's gate without its TPU tiling conditions."""
    return (model.training and cfg.fused_train_blocks and cfg.block_impl == "xla_approx"
            and cfg.layer_scale_init_value > 0 and not cfg.remat_blocks)


def _stem_conv(x: torch.Tensor, conv: nn.Conv2d, cfg: ConvNeXtConfig) -> torch.Tensor:
    """Audio patchify stem; F.conv2d drops the remainder rows/cols exactly
    as the JAX package's patch reshape does. Where kernel == stride and the
    pad is a multiple of the kernel, the JAX package computes the stem as one
    patch GEMM (one bf16 rounding), and so does this under ``acc_f32``."""
    (kh, kw), stride, pad = cfg.stem_geometry()
    patch_gemm = (kh, kw) == stride and pad[0] % kh == 0 and pad[1] % kw == 0
    return L.conv2d(x, conv.weight, conv.bias, stride=stride, padding=pad,
                    acc_f32=patch_gemm)


def forward_features(
    model: ConvNeXtModule,
    x: torch.Tensor,
    cfg: ConvNeXtConfig,
    return_frame_embeddings: bool = False,
    drop_path_scales: Optional[List[Optional[torch.Tensor]]] = None,
    tap: Optional[Callable[[str, torch.Tensor], None]] = None,
) -> torch.Tensor:
    """Spectrogram image (B, T, M, 1) -> pooled (B, C) or frames (B, H, W, C).

    4x (downsample, stage), then freq-mean + time-(max+mean) pooling and the
    final LayerNorm; frame embeddings are the pre-norm stage-4 output.
    In training mode, ``drop_path_scales`` holds one draw per block
    (``draw_drop_path_scales``; None = no drop path), and ``remat_blocks``
    recomputes the unfused blocks in the backward. ``tap(name, x)``, when
    given, sees each layer's output (the stem with its LN, each downsample,
    each block, the pooling, the final LN): the layer-by-layer view that
    tests use to find where two forwards part.
    """
    if tap is None:
        tap = _no_tap
    train = model.training
    fused = cfg.block_impl == "xla_approx" and not train
    fused_train = fused_train_route(model, cfg)
    remat = train and cfg.remat_blocks
    scales = drop_path_scales if train and drop_path_scales is not None \
        else [None] * sum(cfg.depths)
    cur = 0
    prev_fused = False
    for i in range(4):
        ds = model.downsample_layers[i]
        if i == 0:
            x = ds[1](_stem_conv(x, ds[0], cfg))
            tap("stem", x)
        else:
            # after a fused stage the JAX package downsamples by patch GEMM
            # (one bf16 rounding); otherwise by conv (its conv2d rounding)
            x = L.conv2d(ds[0](x), ds[1].weight, ds[1].bias, stride=(2, 2),
                         acc_f32=prev_fused)
            tap(f"downsample {i}", x)
        stage_fused = (fused or fused_train) and i in FUSED_STAGES
        for j, blk in enumerate(model.stages[i]):
            s = scales[cur + j]
            if stage_fused:
                x = _fused_block_train(x, blk, s) if train else _fused_block(x, blk)
            elif remat:
                x = torch.utils.checkpoint.checkpoint(
                    _block_apply, x, blk, cfg.block_impl, s, use_reentrant=False)
            else:
                x = _block_apply(x, blk, cfg.block_impl, s)
            tap(f"stage {i + 1} block {j}" + (" (fused)" if stage_fused else ""), x)
        cur += len(model.stages[i])
        prev_fused = stage_fused

    if return_frame_embeddings:
        return x  # (B, H, W, C) pre-norm, reference convnext.py:276-277
    x = x.mean(dim=2)  # freq
    x = x.amax(dim=1) + x.mean(dim=1)  # time
    tap("pooling", x)
    x = model.norm(x)
    tap("final norm", x)
    return x


def _no_tap(name: str, x: torch.Tensor) -> None:
    pass


def _frontend_and_bn0(
    model: ConvNeXtModule,
    waveform_or_spec: torch.Tensor,
    cfg: ConvNeXtConfig,
    frontend: LogMelFrontend,
    compute_dtype=torch.float32,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    mixup_lambda: Optional[torch.Tensor] = None,
    shard: Optional[Shard] = None,
) -> torch.Tensor:
    """Waveform (B, N) -> normalized spectrogram image (B, T, M, 1).

    Eval: bn0 folds into the frontend as a per-mel-bin f32 affine. Train
    (reference convnext.py:287-316): the waveform augmentations that
    ``cfg.augment`` switches on (gain, roll, speed perturbation, in the
    reference's order), the log-mel frontend, bn0 with batch statistics
    (its running statistics update in place), SpecAugment, then mixup of
    the 2B clips into B. Draws come from ``generator``; without one, no
    augmentation runs. With a ``shard``, bn0's statistics and the
    SpecAugment draws are the global batch's (``mixup_lambda`` is already
    this process's rows).
    """
    x = waveform_or_spec
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim == 2:
        if not train and cfg.frontend.top_db is None:
            spec = frontend(x, affine=model.bn0.fold(cfg.bn_eps))
            return spec.permute(0, 2, 3, 1).to(compute_dtype)
        a = cfg.augment
        if train and generator is not None:
            if a.use_pydub_augment:
                x = A.gain_augment(x, A.draw_gain(generator, a.gain_augment_db))
            if a.use_roll_augment:
                x = A.roll_augment(x, A.draw_roll(generator, a.roll_shift_range))
            if a.use_speed_perturb:
                x = A.speed_perturb(x, A.draw_speed(generator, x.shape[-1],
                                                    a.speed_perturb_rates, a.speed_perturb_p))
        x = frontend(x).permute(0, 2, 3, 1)
    x = x.to(compute_dtype)
    bn = model.bn0
    if train:
        x = L.batch_norm_train(x[..., 0], bn.weight, bn.bias, bn.running_mean, bn.running_var,
                               eps=cfg.bn_eps, axis=2,
                               all_reduce=None if shard is None else shard.all_reduce)[..., None]
    else:
        x = L.batch_norm_apply(x[..., 0], bn.weight, bn.bias, bn.running_mean, bn.running_var,
                               eps=cfg.bn_eps, axis=2)[..., None]
    if train and cfg.augment.use_spec_augment and generator is not None:
        draws = None
        if shard is not None:
            sa = cfg.augment.spec_augment
            draws = tuple(tuple(t[shard.rows] for t in draw_stripes(generator, shard.total, w, k))
                          for w, k in ((sa.time_drop_width, sa.time_stripes_num),
                                       (sa.freq_drop_width, sa.freq_stripes_num)))
        x = spec_augment(x, time_axis=1, freq_axis=2, cfg=cfg.augment.spec_augment,
                         generator=generator, draws=draws)
    if train and mixup_lambda is not None:
        x = do_mixup(x, mixup_lambda)
    return x


def forward(
    model: ConvNeXtModule,
    waveform: torch.Tensor,
    cfg: ConvNeXtConfig,
    frontend: LogMelFrontend,
    compute_dtype=torch.float32,
    tap: Optional[Callable[[str, torch.Tensor], None]] = None,
) -> Dict[str, torch.Tensor]:
    """Eval forward (reference convnext.py:287-331): sigmoid probabilities
    and logits, both f32. ``tap`` as in ``forward_features``, which also
    sees the frontend's output (bn0 folded in) and the head's logits."""
    x = _frontend_and_bn0(model, waveform, cfg, frontend, compute_dtype)
    if tap is not None:
        tap("frontend", x)
    emb = forward_features(model, x, cfg, tap=tap)
    head = model.head_audioset
    logits = L.linear(emb, head.weight, head.bias).float()
    if tap is not None:
        tap("head", logits)
    return {"clipwise_output": torch.sigmoid(logits), "clipwise_logits": logits}


def forward_train(
    model: ConvNeXtModule,
    waveform: torch.Tensor,
    cfg: ConvNeXtConfig,
    frontend: LogMelFrontend,
    generator: Optional[torch.Generator] = None,
    mixup_lambda: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    shard: Optional[Shard] = None,
) -> Dict[str, torch.Tensor]:
    """Training forward (``model`` in training mode): the train prologue of
    ``_frontend_and_bn0``, then the trunk with one drop-path draw per block
    and the head. Returns the outputs; bn0's running statistics are updated
    in place (the JAX package returns them instead). Draws come from
    ``generator`` in the order: waveform augmentations, SpecAugment, drop
    path; without one, nothing random runs. With a ``shard``, ``waveform``
    holds this process's rows of the global batch (see :class:`Shard`)."""
    x = _frontend_and_bn0(model, waveform, cfg, frontend, compute_dtype, train=True,
                          generator=generator, mixup_lambda=mixup_lambda, shard=shard)
    if shard is None:
        scales = draw_drop_path_scales(generator, x.shape[0], cfg)
    elif shard.drop_path_generator is not None:
        scales = draw_drop_path_scales(shard.drop_path_generator, x.shape[0], cfg)
    else:  # the global batch's draws, these rows (after mixup: half of each)
        half = 2 if mixup_lambda is not None else 1
        rows = slice(shard.rows.start // half, shard.rows.stop // half)
        scales = [None if s is None else s[rows]
                  for s in draw_drop_path_scales(generator, shard.total // half, cfg)]
    emb = forward_features(model, x, cfg, drop_path_scales=scales)
    head = model.head_audioset
    logits = L.linear(emb, head.weight, head.bias).float()
    return {"clipwise_output": torch.sigmoid(logits), "clipwise_logits": logits}


def forward_scene_embeddings(
    model: ConvNeXtModule,
    waveform: torch.Tensor,
    cfg: ConvNeXtConfig,
    frontend: LogMelFrontend,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """(B, N) -> (B, embed_dim) post-norm pooled embedding (convnext.py:333-366)."""
    x = _frontend_and_bn0(model, waveform, cfg, frontend, compute_dtype)
    return forward_features(model, x, cfg)


def forward_frame_embeddings(
    model: ConvNeXtModule,
    waveform: torch.Tensor,
    cfg: ConvNeXtConfig,
    frontend: LogMelFrontend,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """(B, N) -> (B, C, H, W) pre-norm frame embeddings (convnext.py:369-402),
    in the reference's NCHW layout: (B, 768, 31, 7) for 10-s clips."""
    x = _frontend_and_bn0(model, waveform, cfg, frontend, compute_dtype)
    feats = forward_features(model, x, cfg, return_frame_embeddings=True)
    return feats.permute(0, 3, 1, 2).contiguous()
