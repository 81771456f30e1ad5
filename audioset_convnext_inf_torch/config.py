"""Configuration tree of the PyTorch port.

The same dataclasses, field names and JSON form as the JAX package's
``config.py``, kept as the port's own copy so that a config written by
either package loads in the other (checkpoints carry this JSON). The JAX
package's ``RuntimeConfig`` (mesh axis, donation) has no counterpart: no
code of either package reads it; the device, the compute dtype and the
devices of a data-parallel run are arguments of the entry points.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# Global audio constants (reference utils/config.py:8-9)
SAMPLE_RATE = 32000
CLIP_SECONDS = 10
CLIP_SAMPLES = SAMPLE_RATE * CLIP_SECONDS  # 320000
NUM_CLASSES = 527

# int16 PCM -> float32 decode scale (reference utilities.py:226-227). Every
# decode site multiplies by THIS value in float32, which keeps the decode
# bit-identical to the JAX package's.
INT16_SCALE = 1.0 / 32767.0


@dataclass(frozen=True)
class FrontendConfig:
    """STFT -> log-mel frontend, matching torchlibrosa's frozen parameters.

    Reference: pytorch/convnext.py:161-200 (Spectrogram + LogmelFilterBank
    with window='hann' periodic, center=True, pad_mode='reflect', power
    spectrum, Slaney mel, ref=1.0, amin=1e-10, top_db=None).
    """

    sample_rate: int = SAMPLE_RATE
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 320
    n_mels: int = 224
    fmin: float = 50.0
    fmax: float = 14000.0
    amin: float = 1e-10
    ref: float = 1.0
    top_db: Optional[float] = None
    center: bool = True
    pad_mode: str = "reflect"
    # Precision of the DFT and mel products (ops/frontend.py maps each value
    # onto explicit per-op settings): "highest" = true f32 with TF32 off,
    # "high" = TF32, "default" = single-pass bf16 operands with f32
    # accumulation (the bf16 serving setting; log-domain error in
    # near-silent bins is real, so keep "highest" for f32 parity work).
    precision: str = "highest"
    # DFT algorithm: "conv" (default) = the windowed DFT as one strided 1-D
    # conv over hop-sized blocks; "direct" = frame + one GEMM pair; "ct" =
    # the two-stage Cooley-Tukey GEMM DFT ("direct" where n_fft does not
    # factor); "rfft" = torch.fft.rfft (ops/frontend.py).
    dft_impl: str = "conv"

    @property
    def freq_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        if self.center:
            padded = num_samples + 2 * (self.n_fft // 2)
        else:
            padded = num_samples
        return (padded - self.n_fft) // self.hop_length + 1


@dataclass(frozen=True)
class SpecAugmentConfig:
    """Time/freq stripe dropout (reference: convnext.py:203-210), applied
    by the training forward (ops/specaugment.py)."""

    time_drop_width: int = 64
    time_stripes_num: int = 2
    freq_drop_width: int = 28
    freq_stripes_num: int = 2


@dataclass(frozen=True)
class AugmentConfig:
    """Waveform/spectrogram augmentation switches of the training forward
    (reference: convnext.py:145-217; ops/augment.py, ops/specaugment.py)."""

    use_speed_perturb: bool = False
    speed_perturb_rates: Tuple[float, float] = (0.5, 1.5)
    speed_perturb_p: float = 0.5
    use_pydub_augment: bool = False
    gain_augment_db: int = 7
    use_roll_augment: bool = False
    roll_shift_range: int = 50
    use_spec_augment: bool = True
    spec_augment: SpecAugmentConfig = field(default_factory=SpecAugmentConfig)
    mixup_alpha: float = 0.0


@dataclass(frozen=True)
class ConvNeXtConfig:
    """ConvNeXt trunk configuration (reference: convnext.py:130-261, 569-901)."""

    name: str = "convnext_tiny"
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    num_classes: int = NUM_CLASSES
    in_chans: int = 1
    drop_path_rate: float = 0.0
    layer_scale_init_value: float = 1e-6
    head_init_scale: float = 1.0
    # Audio patchify stem keyed on the post-stem spatial dims
    # (reference convnext.py:674-707).
    after_stem_dim: Tuple[int, ...] = (252, 56)
    ln_eps: float = 1e-6
    bn_eps: float = 1e-5
    # "xla": exact erf GELU (f32 parity); "xla_approx": tanh GELU, and at
    # eval stages 3-4 run the fused block kernel (ops/fused_block.py), with
    # bf16 activations stages 1-2 too, at the unfused block's rounding points.
    block_impl: str = "xla"
    # Training: recompute the plain blocks in the backward
    # (torch.utils.checkpoint) instead of keeping their activations.
    remat_blocks: bool = False
    # Training: stages 3-4 run the fused block kernels, forward and backward
    # (ops/fused_block_train.py); needs block_impl="xla_approx", layer scale
    # and no remat_blocks.
    fused_train_blocks: bool = False
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)

    @property
    def embed_dim(self) -> int:
        return self.dims[-1]

    def stem_geometry(self) -> Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]:
        """(kernel, stride, padding) of the audio patchify stem.

        Mirrors the after_stem_dim dispatch at reference convnext.py:674-703.
        Padding is (time, freq) applied symmetrically.
        """
        asd = tuple(self.after_stem_dim)
        table = {
            (252, 56): ((4, 4), (4, 4), (4, 0)),
            (504, 28): ((4, 8), (2, 8), (5, 0)),
            (504, 56): ((4, 4), (2, 4), (5, 0)),
            (56,): ((18, 4), (18, 4), (9, 0)),
            (112,): ((9, 2), (9, 2), (4, 0)),
        }
        if asd not in table:
            raise ValueError(
                f"after_stem_dim must be one of {sorted(map(list, table))}, got {list(asd)}"
            )
        return table[asd]


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def config_to_json(cfg: Any) -> str:
    return json.dumps(to_dict(cfg), indent=2)


_NESTED_FIELDS = {
    "frontend": FrontendConfig,
    "augment": AugmentConfig,
    "spec_augment": SpecAugmentConfig,
}


def _from_dict(cls, d):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in _NESTED_FIELDS and isinstance(v, dict):
            kwargs[f.name] = _from_dict(_NESTED_FIELDS[f.name], v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def convnext_config_from_json(s: str) -> ConvNeXtConfig:
    return _from_dict(ConvNeXtConfig, json.loads(s))
