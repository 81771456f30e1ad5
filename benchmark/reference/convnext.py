"""Plain float32 ConvNeXt audio tagger: the benchmark's reference.

Written from the published descriptions, in plain ``torch`` operations and
NCHW, with TF32 off, and importing nothing of the program under test:

 - frontend: torchlibrosa's ``Spectrogram`` + ``LogmelFilterBank`` as the
   audio ConvNeXt uses them (periodic Hann window, centered reflect-padded
   STFT, power spectrum, Slaney mel filters, ``10 log10(max(x, amin))``);
 - bn0 over the mel bins (eval: running statistics; train: batch
   statistics), the audio patchify stem (4x4, stride 4, time padding 4) and
   its channels-first LayerNorm;
 - ConvNeXt blocks (Liu et al. 2022, "A ConvNet for the 2020s"): 7x7
   depthwise conv, LayerNorm, Linear 4C, GELU (erf or tanh), Linear C, layer
   scale, drop path; LayerNorm + 2x2 stride-2 conv downsamples;
 - pooling as in topel/audioset-convnext-inf: mean over frequency, then
   max + mean over time, final LayerNorm, the 527-way head;
 - training: SpecAugment stripes, mixup of paired clips, clip BCE from
   logits, AdamW with the cosine one-cycle learning rate.

Every function takes a reference-keyed state dict ``sd`` (``bn0.*``,
``downsample_layers.i.j.*``, ``stages.i.j.{dwconv,norm,pwconv1,pwconv2,gamma}``,
``norm.*``, ``head_audioset.*``) and a model config as a plain dict
(``benchmark/configs/*.json``'s ``model``).

``quant`` (a float8 dtype or None) rounds both operands of every product
(the mel product, every convolution and linear layer) to that dtype with
one scale per tensor, and in training also the gradient that flows into a
product: the reference computed in a precision below bf16, which serves as
the control of the correctness checks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

INT16_SCALE = 1.0 / 32767.0  # the AudioSet HDF5 convention: x / 32767

StateDict = Dict[str, torch.Tensor]


@contextlib.contextmanager
def true_f32() -> Iterator[None]:
    """float32 matmuls and convolutions without TF32, restored after."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Low-precision control: fake quantisation of product operands
# ---------------------------------------------------------------------------


def _round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` with one scale for the tensor (its largest
    magnitude maps to the format's largest finite value), back in f32."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Quant(torch.autograd.Function):
    """Forward: round to e4m3; backward: the incoming gradient to e5m2."""

    @staticmethod
    def forward(ctx, x, dtype):
        return _round_to(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return _round_to(g, torch.float8_e5m2), None


def _q(x: torch.Tensor, quant) -> torch.Tensor:
    if quant is None:
        return x
    return _Quant.apply(x, quant)


def linear(x, w, b, quant=None):
    return F.linear(_q(x, quant), _q(w, quant), b)


def conv2d(x, w, b, quant=None, **kw):
    return F.conv2d(_q(x, quant), _q(w, quant), b, **kw)


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear to 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = math.log(6.4) / 27.0
    lin = f / f_sp
    log = min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log, lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filters(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) Slaney-normalised triangles (librosa's
    ``filters.mel(htk=False, norm='slaney')``), float64."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    lower = (freqs[None, :] - hz[:-2, None]) / (hz[1:-1] - hz[:-2])[:, None]
    upper = (hz[2:, None] - freqs[None, :]) / (hz[2:] - hz[1:-1])[:, None]
    tri = np.maximum(0.0, np.minimum(lower, upper))
    return tri * (2.0 / (hz[2:] - hz[:-2]))[:, None]


def log_mel(wave: torch.Tensor, mcfg: dict, quant=None) -> torch.Tensor:
    """(B, N) float32 waveform -> (B, T, n_mels) log-mel in dB."""
    fe = mcfg["frontend"]
    n_fft, hop = fe["n_fft"], fe["hop_length"]
    win = torch.hann_window(fe["win_length"], periodic=True, dtype=torch.float64)
    if fe["win_length"] < n_fft:
        lpad = (n_fft - fe["win_length"]) // 2
        win = F.pad(win, (lpad, n_fft - fe["win_length"] - lpad))
    spec = torch.stft(wave.float(), n_fft, hop_length=hop, win_length=n_fft,
                      window=win.to(device=wave.device, dtype=torch.float32), center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.real.square() + spec.imag.square()  # (B, F, T)
    mel = torch.from_numpy(mel_filters(fe["sample_rate"], n_fft, fe["n_mels"], fe["fmin"],
                                       fe["fmax"])).to(device=wave.device, dtype=torch.float32)
    melp = linear(power.transpose(1, 2), mel, None, quant)  # (B, T, n_mels)
    amin, ref = fe["amin"], fe["ref"]
    return 10.0 * torch.log10(torch.clamp(melp, min=amin)) - 10.0 * math.log10(max(amin, ref))


# ---------------------------------------------------------------------------
# Trunk
# ---------------------------------------------------------------------------


def _ln_last(x, sd, key, eps):
    return F.layer_norm(x, x.shape[-1:], sd[key + ".weight"], sd[key + ".bias"], eps)


def _ln_channels_first(x, sd, key, eps):
    return _ln_last(x.permute(0, 2, 3, 1), sd, key, eps).permute(0, 3, 1, 2)


def stem_geometry(after_stem_dim: Sequence[int]):
    """(kernel, stride, padding) of the audio stem for ``after_stem_dim``."""
    table = {
        (252, 56): ((4, 4), (4, 4), (4, 0)),
        (504, 28): ((4, 8), (2, 8), (5, 0)),
        (504, 56): ((4, 4), (2, 4), (5, 0)),
    }
    return table[tuple(after_stem_dim)]


def block(x, sd, key, mcfg, scale=None, quant=None):
    """One ConvNeXt block on NCHW x; ``scale`` (B,) is its drop-path draw."""
    c = x.shape[1]
    y = conv2d(x, sd[key + ".dwconv.weight"], sd[key + ".dwconv.bias"], quant,
               padding=3, groups=c)
    y = y.permute(0, 2, 3, 1)
    y = _ln_last(y, sd, key + ".norm", mcfg["ln_eps"])
    y = linear(y, sd[key + ".pwconv1.weight"], sd[key + ".pwconv1.bias"], quant)
    y = F.gelu(y, approximate="tanh" if mcfg["gelu"] == "tanh" else "none")
    y = linear(y, sd[key + ".pwconv2.weight"], sd[key + ".pwconv2.bias"], quant)
    y = y * sd[key + ".gamma"]
    y = y.permute(0, 3, 1, 2)
    if scale is not None:
        y = y * scale.to(y.device).reshape(-1, 1, 1, 1)
    return x + y


def trunk(x, sd, mcfg, scales: Optional[List] = None, quant=None):
    """Normalised spectrogram (B, 1, T, M) -> logits (B, classes)."""
    eps = mcfg["ln_eps"]
    k, s, p = stem_geometry(mcfg["after_stem_dim"])
    x = conv2d(x, sd["downsample_layers.0.0.weight"], sd["downsample_layers.0.0.bias"], quant,
               stride=s, padding=p)
    x = _ln_channels_first(x, sd, "downsample_layers.0.1", eps)
    n = 0
    for i, depth in enumerate(mcfg["depths"]):
        if i > 0:
            x = _ln_channels_first(x, sd, f"downsample_layers.{i}.0", eps)
            x = conv2d(x, sd[f"downsample_layers.{i}.1.weight"],
                       sd[f"downsample_layers.{i}.1.bias"], quant, stride=2)
        for j in range(depth):
            x = block(x, sd, f"stages.{i}.{j}", mcfg, None if scales is None else scales[n], quant)
            n += 1
    x = x.mean(dim=3)  # frequency
    x = x.amax(dim=2) + x.mean(dim=2)  # time
    x = _ln_last(x, sd, "norm", eps)
    return linear(x, sd["head_audioset.weight"], sd["head_audioset.bias"], quant)


def bn0_eval(logmel, sd, eps):
    """(B, T, M) -> (B, 1, T, M) with bn0's running statistics."""
    inv = sd["bn0.weight"] / torch.sqrt(sd["bn0.running_var"] + eps)
    return ((logmel - sd["bn0.running_mean"]) * inv + sd["bn0.bias"])[:, None]


def decode(pcm: torch.Tensor) -> torch.Tensor:
    return pcm.float() * INT16_SCALE if pcm.dtype == torch.int16 else pcm.float()


@torch.no_grad()
def probabilities(sd: StateDict, pcm: torch.Tensor, mcfg: dict, quant=None,
                  block_rows: int = 16) -> torch.Tensor:
    """Eval forward of int16 or f32 clips (B, N) -> sigmoid probabilities
    (B, classes) in f32, ``block_rows`` clips at a time."""
    out = []
    with true_f32():
        for i in range(0, pcm.shape[0], block_rows):
            x = bn0_eval(log_mel(decode(pcm[i:i + block_rows]), mcfg, quant), sd,
                         mcfg["bn_eps"])
            out.append(torch.sigmoid(trunk(x, sd, mcfg, quant=quant)))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def drop_stripes(x: torch.Tensor, axis: int, widths: torch.Tensor, u: torch.Tensor):
    """Zero, per sample, the stripes [begin, begin + width) along ``axis``,
    begin = floor(u * (size - width)) (torchlibrosa's DropStripes)."""
    size = x.shape[axis]
    widths, u = widths.to(x.device), u.to(x.device)
    begins = torch.floor(u.float() * (size - widths).float()).long()
    pos = torch.arange(size, device=x.device)
    keep = torch.ones(x.shape[0], size, device=x.device, dtype=x.dtype)
    for k in range(widths.shape[1]):
        hit = (pos[None] >= begins[:, k:k + 1]) & (pos[None] < (begins + widths)[:, k:k + 1])
        keep = keep * (~hit).to(x.dtype)
    shape = [1] * x.ndim
    shape[0], shape[axis] = x.shape[0], size
    return x * keep.reshape(shape)


def spectrogram_stats(x: torch.Tensor):
    """bn0's batch statistics of a (2B, T, M) log-mel: per-bin mean and
    biased variance over clips and frames (constants: the frontend has no
    parameters, so no gradient flows into them)."""
    mean = x.mean(dim=(0, 1))
    return mean, (x - mean).square().mean(dim=(0, 1))


def train_forward(sd: StateDict, x, stats, mcfg: dict, draws: dict, rows: slice, quant=None):
    """Training forward of the clips ``rows`` (an even start and stop) of a
    (2B, T, M) log-mel ``x`` with the step's draws -> logits of their mixed
    pairs.

    ``stats``: bn0's (mean, var) of the whole batch; ``draws``: ``lam``
    (2B,) mixup weights in pairs, ``time`` and ``freq`` SpecAugment stripes
    (widths, u) for the 2B clips, ``drop`` a list of (B,) drop-path scales
    or None per block."""
    mean, var = stats
    x = (x[rows] - mean) / torch.sqrt(var + mcfg["bn_eps"]) * sd["bn0.weight"] + sd["bn0.bias"]
    x = drop_stripes(x, 1, *(t[rows] for t in draws["time"]))
    x = drop_stripes(x, 2, *(t[rows] for t in draws["freq"]))
    lam = draws["lam"][rows].to(x.device).reshape(-1, 1, 1)
    x = x[0::2] * lam[0::2] + x[1::2] * lam[1::2]
    half = slice(rows.start // 2, rows.stop // 2)
    scales = [None if d is None else d[half] for d in draws["drop"]]
    return trunk(x[:, None], sd, mcfg, scales, quant)


def onecycle_lr(step: int, tcfg: dict) -> float:
    """Cosine one-cycle schedule (optax ``cosine_onecycle_schedule``)."""
    v0 = tcfg["max_lr"] / tcfg["div_factor"]
    v1 = tcfg["max_lr"]
    v2 = v0 / tcfg["final_div_factor"]
    b1, b2 = int(tcfg["pct_start"] * tcfg["total_steps"]), int(tcfg["total_steps"])

    def cos(a, b, pct):
        return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1)

    if step < b1:
        return cos(v0, v1, step / b1)
    if step < b2:
        return cos(v1, v2, (step - b1) / (b2 - b1))
    return v2


def train_steps(sd0: StateDict, batches: Sequence, draws: Sequence[dict], mcfg: dict,
                tcfg: dict, quant=None, loss_rows: Optional[slice] = None,
                block: Optional[int] = None) -> dict:
    """AdamW steps of the training recipe from ``sd0`` (left unchanged).

    ``batches``: (pcm (2B, N), target (2B, C)) per step; ``draws`` per
    step as for :func:`train_forward`. The loss is the mean binary
    cross-entropy over the B mixed clips and the classes; each step's
    gradient is summed over blocks of ``block`` clips (default: all), so
    that large batches fit. Returns ``losses`` (list of floats), ``grads1``
    (the first step's gradient per parameter) and ``params`` (the
    parameters after the last step), all f32. ``loss_rows`` takes the loss
    over those mixed clips alone (a planted fault)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    names = [k for k in sd0 if not k.startswith("bn0.running")]
    p = {k: sd0[k].detach().clone().float().requires_grad_(k in names) for k in sd0}
    mu = {k: torch.zeros_like(p[k]) for k in names}
    nu = {k: torch.zeros_like(p[k]) for k in names}
    losses, grads1 = [], None
    with true_f32():
        for step, ((pcm, target), dr) in enumerate(zip(batches, draws)):
            for k in names:
                p[k].grad = None
            n = pcm.shape[0]
            use = torch.zeros(n // 2, dtype=torch.bool, device=target.device)
            use[slice(None) if loss_rows is None else loss_rows] = True
            count = float(use.sum()) * target.shape[1]
            lam = dr["lam"].to(target.device).reshape(-1, 1)
            tmix = target[0::2] * lam[0::2] + target[1::2] * lam[1::2]
            with torch.no_grad():
                x = log_mel(decode(pcm), mcfg, quant)
                stats = spectrogram_stats(x)
            total = 0.0
            size = block or n
            for a in range(0, n, size):
                rows = slice(a, min(a + size, n))
                logits = train_forward(p, x, stats, mcfg, dr, rows, quant)
                half = slice(a // 2, rows.stop // 2)
                keep = use[half]
                loss = F.binary_cross_entropy_with_logits(
                    logits.float()[keep], tmix[half][keep].float(), reduction="sum") / count
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            grads = {k: p[k].grad.detach().clone() for k in names}
            if grads1 is None:
                grads1 = grads
            lr, t = onecycle_lr(step, tcfg), step + 1
            with torch.no_grad():
                for k in names:
                    g = grads[k]
                    mu[k].mul_(b1).add_((1 - b1) * g)
                    nu[k].mul_(b2).add_((1 - b2) * g * g)
                    u = (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
                    if p[k].ndim > 1:
                        u = u + tcfg["weight_decay"] * p[k]
                    p[k].add_(-lr * u)
    return {"losses": losses, "grads1": grads1,
            "params": {k: p[k].detach() for k in names}}
