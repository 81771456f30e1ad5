"""Log-mel frontend of the PyTorch port.

The same pipeline as the JAX package's ``ops/frontend.py``, which replaces
the reference's torchlibrosa ``Spectrogram`` + ``LogmelFilterBank``
(pytorch/convnext.py:176-200):

    waveform -(reflect pad, hop-sized blocks)-> blocks  (B, hop, nb)
            -(one conv1d with the window-scaled DFT)-> re|im (B, 2F, T)
            -(re^2 + im^2)                     -> power   (B, T, F)
            -(power @ mel^T)                   -> mel     (B, T, 224)
            -(10*log10(clip(., amin)) - 10*log10(max(amin, ref)))

``dft_impl`` picks the DFT, as in the JAX package: "conv" (above, the
default), "direct" (frames times one (n_fft, 2F) matrix), "ct" (a two-stage
Cooley-Tukey factorisation n_fft = P*Q as small products, its bins in their
own order, which the mel matrix absorbs; "direct" where n_fft has no such
factorisation) and "rfft" (``torch.fft.rfft``, cuFFT on the card, exact
f32, no precision setting). The constants (window, DFT bases, mel matrix)
are built in float64 numpy and cast, exactly as the JAX package builds them.

``precision`` selects the arithmetic of the DFT and mel products, per op:
"highest" is true f32 (TF32 off for cuBLAS and cuDNN), "high" is TF32 (the
port's counterpart of the TPU's bf16x3 passes), and "default" is
single-pass bf16 operands with f32 accumulation. Under "default" the
conv-DFT is a bf16 cuDNN convolution, which accumulates in f32 and rounds
re/im to bf16 once on output.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audioset_convnext_inf_torch.config import FrontendConfig
from audioset_convnext_inf_torch.ops.precision import fp32_precision, mm_f32acc

_PRECISIONS = ("highest", "high", "default")

# ---------------------------------------------------------------------------
# Host-side constant builders (float64 numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def hann_window_periodic(win_length: int, dtype=np.float64) -> np.ndarray:
    """Periodic ("fftbins=True") Hann window, as torchlibrosa uses it."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return w.astype(dtype)


def _hz_to_mel_slaney(frequencies: np.ndarray) -> np.ndarray:
    """Slaney (Auditory Toolbox) Hz->mel: linear below 1 kHz, log above."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = frequencies >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(frequencies, 1e-10) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float,
    fmax: float,
    dtype=np.float32,
) -> np.ndarray:
    """Slaney-scale, Slaney-normalized triangular mel filterbank.

    Returns weights of shape (n_mels, n_fft//2 + 1), the math of
    ``librosa.filters.mel(..., htk=False, norm='slaney')``.
    """
    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_freqs, dtype=np.float64)

    mel_min = _hz_to_mel_slaney(np.array(fmin))
    mel_max = _hz_to_mel_slaney(np.array(fmax))
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(dtype)


@lru_cache(maxsize=8)
def _dft_bases(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Window-scaled real-DFT bases: (n_fft, n_fft//2+1) cos and -sin matrices,
    for X[k] = sum_n x[n] w[n] exp(-2i pi k n / N)."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    window = _padded_window(n_fft, win_length)
    cos_b = np.cos(ang) * window[:, None]
    sin_b = -np.sin(ang) * window[:, None]
    return cos_b.astype(np.float32), sin_b.astype(np.float32)


def _padded_window(n_fft: int, win_length: int) -> np.ndarray:
    """The periodic Hann window, center-padded to n_fft (float64)."""
    window = hann_window_periodic(win_length)
    if win_length < n_fft:  # librosa pad_center
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def _ct_factors(n_fft: int) -> Optional[Tuple[int, int]]:
    """n_fft = P*Q with P even and as square as possible (1024 -> 32*32,
    512 -> 16*32); None when there is no such split."""
    best = None
    p = 2
    while p * p <= n_fft:
        if n_fft % p == 0 and p % 2 == 0:
            best = (p, n_fft // p)
        p += 1
    return best


@lru_cache(maxsize=8)
def _ct_bases(n_fft: int, win_length: int):
    """Constants of the two-stage DFT (float64, rounded to float32).

    With n = P*n2 + n1 (n1 < P, n2 < Q) and k = Q*q + r (r < Q, q <= P/2):
        I[n1, r]  = sum_n2 x[P n2 + n1] W_Q^{n2 r}          (inner product)
        J[r, n1]  = W_N^{n1 r} I[n1, r]                      (twiddle)
        X[Qq + r] = sum_n1 J[r, n1] W_P^{n1 q}               (outer product)
    Returns (P, Q, window, CQ, SQ, TR, TI, CP, SP): inner bases (Q, Q),
    twiddles (Q, P) indexed [r, n1], outer bases (P, P//2+1).
    """
    pq = _ct_factors(n_fft)
    if pq is None:
        raise ValueError(f"n_fft={n_fft} has no even factor P with P*P <= n_fft")
    P, Q = pq
    n2 = np.arange(Q, dtype=np.float64)
    r = np.arange(Q, dtype=np.float64)
    ang_q = 2.0 * np.pi * n2[:, None] * r[None, :] / Q
    n1 = np.arange(P, dtype=np.float64)
    ang_t = 2.0 * np.pi * r[:, None] * n1[None, :] / n_fft
    q = np.arange(P // 2 + 1, dtype=np.float64)
    ang_p = 2.0 * np.pi * n1[:, None] * q[None, :] / P
    f32 = np.float32
    return (P, Q, _padded_window(n_fft, win_length).astype(f32),
            np.cos(ang_q).astype(f32), (-np.sin(ang_q)).astype(f32),
            np.cos(ang_t).astype(f32), (-np.sin(ang_t)).astype(f32),
            np.cos(ang_p).astype(f32), (-np.sin(ang_p)).astype(f32))


def ct_bin_to_k(n_fft: int) -> np.ndarray:
    """The "ct" power's column order: flat index r*(P//2+1)+q holds bin
    k = Q*q + r; columns with k > n_fft//2 duplicate bins of the one-sided
    spectrum and map to -1 (their mel weight is zero)."""
    P, Q = _ct_factors(n_fft)
    nq = P // 2 + 1
    out = np.full(Q * nq, -1, np.int64)
    for rr in range(Q):
        for qq in range(nq):
            k = Q * qq + rr
            if k <= n_fft // 2:
                out[rr * nq + qq] = k
    return out


def _uses_ct(cfg: FrontendConfig) -> bool:
    return cfg.dft_impl == "ct" and _ct_factors(cfg.n_fft) is not None


def mel_matrix(cfg: FrontendConfig) -> np.ndarray:
    """(n_mels, bins) f32 mel weights in the column order of ``cfg``'s power
    spectrum: the Slaney filterbank, with "ct"'s bin order folded in."""
    mel = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    if _uses_ct(cfg):
        k_of = ct_bin_to_k(cfg.n_fft)
        mel = np.where(k_of[None, :] >= 0, mel[:, np.clip(k_of, 0, None)], 0.0)
    return mel.astype(np.float32)


@lru_cache(maxsize=8)
def _conv_dft_kernel(n_fft: int, win_length: int, hop: int) -> np.ndarray:
    """Window-scaled DFT bases as a 1-D conv kernel over hop-sized blocks.

    (J, hop, 2*(n_fft//2+1)) HIO kernel with J = ceil(n_fft / hop): frame i
    of the STFT is blocks[i : i+J] contracted against this kernel (rows past
    n_fft zero), cos bins first then -sin bins.
    """
    cos_b, sin_b = _dft_bases(n_fft, win_length)
    basis = np.concatenate([cos_b, sin_b], axis=1)
    j_taps = -(-n_fft // hop)
    kern = np.zeros((j_taps, hop, basis.shape[1]), np.float32)
    for j in range(j_taps):
        seg = basis[j * hop : min((j + 1) * hop, n_fft)]
        kern[j, : seg.shape[0]] = seg
    return kern


def conv_dft_weight(cfg: FrontendConfig, device=None) -> torch.Tensor:
    """The conv-DFT kernel in conv1d's (Cout=2F, Cin=hop, J) layout."""
    kern = _conv_dft_kernel(cfg.n_fft, cfg.win_length, cfg.hop_length)
    return torch.from_numpy(np.ascontiguousarray(kern.transpose(2, 1, 0))).to(device)


def direct_dft_weight(cfg: FrontendConfig, device=None) -> torch.Tensor:
    """[cos | -sin] bases as one (n_fft, 2F) matrix."""
    cos_b, sin_b = _dft_bases(cfg.n_fft, cfg.win_length)
    return torch.from_numpy(np.concatenate([cos_b, sin_b], axis=1)).to(device)


def ct_dft_weight(cfg: FrontendConfig, device=None) -> torch.Tensor:
    """"ct"'s constants packed into one flat f32 tensor (``_ct_unpack``
    slices it): the window (n_fft,), [CQ | SQ] (Q, 2Q), [TR, TI] (2, Q, P)
    and [CP | SP] (P, 2(P//2+1)). ``direct_dft_weight`` where n_fft has no
    factorisation."""
    if not _uses_ct(cfg):
        return direct_dft_weight(cfg, device)
    _, _, window, cq, sq, tr, ti, cp, sp = _ct_bases(cfg.n_fft, cfg.win_length)
    parts = (window, np.concatenate([cq, sq], 1), np.stack([tr, ti]), np.concatenate([cp, sp], 1))
    return torch.from_numpy(np.concatenate([a.ravel() for a in parts])).to(device)


def _ct_unpack(weight: torch.Tensor, n_fft: int) -> Tuple[torch.Tensor, ...]:
    """``ct_dft_weight``'s four constants, as views of ``weight``."""
    P, Q = _ct_factors(n_fft)
    shapes = ((n_fft,), (Q, 2 * Q), (2, Q, P), (P, 2 * (P // 2 + 1)))
    sizes = [int(np.prod(sh)) for sh in shapes]
    return tuple(t.view(sh) for t, sh in zip(torch.split(weight, sizes), shapes))


def rfft_window(cfg: FrontendConfig, device=None) -> torch.Tensor:
    """"rfft"'s one constant: the window, center-padded to n_fft, in f32."""
    return torch.from_numpy(_padded_window(cfg.n_fft, cfg.win_length).astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# Device-side pipeline
# ---------------------------------------------------------------------------


# dft_impl -> its constants, one tensor
_DFT_WEIGHTS = {"conv": conv_dft_weight, "direct": direct_dft_weight, "ct": ct_dft_weight,
                "rfft": rfft_window}


def _check_precision(precision: str) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")


def _check_dft_impl(dft_impl: str) -> None:
    if dft_impl not in _DFT_WEIGHTS:
        raise ValueError(f"unknown dft_impl {dft_impl!r}")


def _matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """(..., K) @ (K, N) -> (..., N) in f32 at the given precision."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if precision == "default":
        y = mm_f32acc(a2.to(torch.bfloat16), b.to(torch.bfloat16))
    else:
        with fp32_precision(precision):
            y = torch.mm(a2.float(), b.float())
    return y.reshape(*lead, b.shape[-1])


def _center_pad(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    # F.pad's reflect mode wants a channel axis; numpy's "reflect" (the JAX
    # package's jnp.pad mode) is torch's "reflect"
    return F.pad(x[:, None, :], (left, right), mode=mode)[:, 0, :]


def frame_signal(x: torch.Tensor, n_fft: int, hop: int, num_frames: int) -> torch.Tensor:
    """Overlapping frames (B, num_frames, n_fft) of an already-centered
    (B, L) signal, zero-extended on the right where the last frame needs it."""
    need = (num_frames - 1) * hop + n_fft
    if need > x.shape[1]:
        x = F.pad(x, (0, need - x.shape[1]))
    return x.unfold(1, n_fft, hop)[:, :num_frames]


def power_spectrogram_conv(
    waveform: torch.Tensor, cfg: FrontendConfig, weight: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Power spectrum (B, T, F) via one strided 1-D convolution over
    hop-sized blocks (Cin=hop, Cout=2F, J taps): the default ``dft_impl``."""
    _check_precision(cfg.precision)
    if waveform.ndim == 1:
        waveform = waveform[None, :]
    b, n = waveform.shape
    num_frames = cfg.num_frames(n)
    pad = cfg.n_fft // 2
    hop = cfg.hop_length
    if weight is None:
        weight = conv_dft_weight(cfg, waveform.device)
    j_taps = weight.shape[-1]
    blocks_needed = num_frames + j_taps - 1
    padded_len = blocks_needed * hop
    x = waveform.float()
    # One pad covers both the reflect centering and the block-alignment
    # tail: the kernel rows past n_fft are zero, so the tail's values are
    # inert (JAX package, ops/frontend.py::power_spectrogram_conv).
    if cfg.center:
        tail = max(0, padded_len - (n + 2 * pad))
        if cfg.pad_mode != "constant" and pad + tail >= n:
            tail = 0  # reflect width must stay < n; short clips re-pad below
        x = _center_pad(x, pad, pad + tail, cfg.pad_mode)
    if padded_len > x.shape[1]:
        x = F.pad(x, (0, padded_len - x.shape[1]))
    blocks = x[:, :padded_len].reshape(b, blocks_needed, hop).transpose(1, 2)
    if cfg.precision == "default":
        y = F.conv1d(blocks.to(torch.bfloat16), weight.to(torch.bfloat16)).float()
    else:
        with fp32_precision(cfg.precision):
            y = F.conv1d(blocks, weight.float())
    y = y[:, :, :num_frames].transpose(1, 2)
    n_freqs = cfg.n_fft // 2 + 1
    re, im = y[..., :n_freqs], y[..., n_freqs:]
    return re * re + im * im


def power_spectrogram(
    waveform: torch.Tensor, cfg: FrontendConfig, weight: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Power spectrum (B, T, F) by framing and one (n_fft, 2F) product
    (``dft_impl="direct"``); torchlibrosa's Spectrogram(power=2.0)."""
    _check_precision(cfg.precision)
    frames = _centered_frames(waveform, cfg)
    if weight is None:
        weight = direct_dft_weight(cfg, waveform.device)
    y = _matmul(frames, weight, cfg.precision)
    n_freqs = cfg.n_fft // 2 + 1
    re, im = y[..., :n_freqs], y[..., n_freqs:]
    return re * re + im * im


def _centered_frames(waveform: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, T, n_fft) f32 frames of the centered (B, N) waveform."""
    if waveform.ndim == 1:
        waveform = waveform[None, :]
    n = waveform.shape[1]
    x = waveform.float()
    if cfg.center:
        x = _center_pad(x, cfg.n_fft // 2, cfg.n_fft // 2, cfg.pad_mode)
    return frame_signal(x, cfg.n_fft, cfg.hop_length, cfg.num_frames(n))


def power_spectrogram_ct(
    waveform: torch.Tensor, cfg: FrontendConfig,
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Two-stage Cooley-Tukey power spectrum (``dft_impl="ct"``), (B, T,
    Q*(P//2+1)) in "ct" bin order (``ct_bin_to_k``; ``mel_matrix`` folds
    the order into the mel product). The JAX package's six einsums as three
    products, each output element the same sum: [ir | ii] = x . [CQ | SQ],
    then jr . [CP | SP] and ji . [SP | CP] (as slices of [CP | SP]); each at
    ``cfg.precision`` (``_matmul``). ``weight``: ``ct_dft_weight``."""
    _check_precision(cfg.precision)
    if weight is None:
        weight = ct_dft_weight(cfg, waveform.device)
    window, inner, twiddle, outer = _ct_unpack(weight, cfg.n_fft)
    P, Q = _ct_factors(cfg.n_fft)
    nq = P // 2 + 1
    frames = _centered_frames(waveform, cfg)
    b, t = frames.shape[:2]
    x = (frames * window).reshape(b, t, Q, P).transpose(2, 3)  # [n1, n2]
    i = _matmul(x, inner, cfg.precision).transpose(2, 3)  # (B, T, 2Q, P): [r, n1]
    ir, ii = i[:, :, :Q], i[:, :, Q:]
    tr, ti = twiddle[0], twiddle[1]
    jr = ir * tr - ii * ti
    ji = ir * ti + ii * tr
    a = _matmul(jr, outer, cfg.precision)  # [jr.CP | jr.SP]
    c = _matmul(ji, outer, cfg.precision)  # [ji.CP | ji.SP]
    xr = a[..., :nq] - c[..., nq:]
    xi = a[..., nq:] + c[..., :nq]
    return (xr * xr + xi * xi).reshape(b, t, Q * nq)


def power_spectrogram_rfft(
    waveform: torch.Tensor, cfg: FrontendConfig, window: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Power spectrum (B, T, F) by ``torch.fft.rfft`` of the windowed
    frames (``dft_impl="rfft"``): an f32 FFT (cuFFT on the card), as the
    JAX package's is XLA's; no precision setting applies."""
    if window is None:
        window = rfft_window(cfg, waveform.device)
    spec = torch.fft.rfft(_centered_frames(waveform, cfg) * window)
    return spec.real * spec.real + spec.imag * spec.imag


def power_to_db(
    mel_power: torch.Tensor, amin: float, ref: float, top_db: Optional[float]
) -> torch.Tensor:
    """torchlibrosa LogmelFilterBank.power_to_db semantics."""
    log_spec = 10.0 * torch.log10(torch.clamp(mel_power, min=amin))
    log_spec = log_spec - 10.0 * float(np.log10(max(amin, ref)))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def log_mel_spectrogram(
    waveform: torch.Tensor,
    cfg: FrontendConfig,
    mel_weights: Optional[torch.Tensor] = None,
    affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    dft_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, num_samples) -> (B, 1, T, n_mels) log-mel, reference layout.

    ``affine=(a, b)`` applies a per-mel-bin ``a*x + b`` in f32 after the
    log: the eval-mode bn0 fold (reference convnext.py:304-306).
    ``mel_weights`` is ``mel_matrix(cfg)`` (for "ct", in its bin order) and
    ``dft_weight`` the precomputed constants of ``cfg.dft_impl``
    (``_DFT_WEIGHTS``); each is built when not given.
    """
    _check_precision(cfg.precision)
    _check_dft_impl(cfg.dft_impl)
    if mel_weights is None:
        mel_weights = torch.from_numpy(mel_matrix(cfg)).to(waveform.device)
    if cfg.dft_impl == "conv":
        power = power_spectrogram_conv(waveform, cfg, dft_weight)
    elif cfg.dft_impl == "rfft":
        power = power_spectrogram_rfft(waveform, cfg, dft_weight)
    elif _uses_ct(cfg):
        power = power_spectrogram_ct(waveform, cfg, dft_weight)
    else:  # "direct", and "ct" where n_fft has no factorisation
        power = power_spectrogram(waveform, cfg, dft_weight)
    mel_power = _matmul(power, mel_weights.t(), cfg.precision)
    logmel = power_to_db(mel_power, cfg.amin, cfg.ref, cfg.top_db)
    if affine is not None:
        a, b = affine
        logmel = logmel * a.float() + b.float()
    return logmel[:, None, :, :]


class LogMelFrontend(nn.Module):
    """Frontend module holding its constants as non-persistent buffers, so
    they follow ``.to(device)`` but never enter the state dict: the mel
    matrix (``mel_matrix``) and the DFT's constants (``dft_weight``)."""

    def __init__(self, cfg: FrontendConfig = FrontendConfig(), device=None):
        super().__init__()
        _check_dft_impl(cfg.dft_impl)
        _check_precision(cfg.precision)
        self.cfg = cfg
        self.register_buffer("mel_weights", torch.from_numpy(mel_matrix(cfg)).to(device),
                             persistent=False)
        self.register_buffer("dft_weight", _DFT_WEIGHTS[cfg.dft_impl](cfg, device),
                             persistent=False)

    def forward(self, waveform: torch.Tensor, affine=None) -> torch.Tensor:
        return log_mel_spectrogram(
            waveform, self.cfg, self.mel_weights, affine=affine, dft_weight=self.dft_weight
        )
