"""User-facing model API of the PyTorch port: factories and the ConvNeXt module.

Mirrors the JAX package's ``models/api.py`` (reference convnext.py:569-901):

 - factories ``convnext_{atto,femto,pico,nano,tiny,small,base}``,
   ``MODEL_REGISTRY`` and ``create_model``;
 - ``ConvNeXt.forward`` / ``forward_scene_embeddings`` /
   ``forward_frame_embeddings`` (reference convnext.py:287,333,369), which
   take numpy arrays or tensors, f32 or int16 PCM, and run eval-mode
   inference under ``torch.inference_mode``;
 - ``ConvNeXt.from_pretrained`` and the factories' ``pretrained_imagenet``.

Everything runs on the card unless the caller passes ``device="cpu"``;
without a card and without a device, construction raises.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from audioset_convnext_inf_torch.checkpoint.convert import load_imagenet_backbone, to_tensors
from audioset_convnext_inf_torch.config import AugmentConfig, ConvNeXtConfig
from audioset_convnext_inf_torch.device import resolve_device
from audioset_convnext_inf_torch.models import convnext as F
from audioset_convnext_inf_torch.ops.frontend import LogMelFrontend
from audioset_convnext_inf_torch.ops.pcm import decode_pcm_if_int16


class ConvNeXt(F.ConvNeXtModule):
    """The audio ConvNeXt with its frontend, config and compute dtype.

    Its state dict carries exactly the reference keys; the frontend's
    constants are non-persistent buffers.
    """

    def __init__(self, cfg: ConvNeXtConfig, compute_dtype=torch.float32,
                 auto_fast_serving: bool = True, device=None, seed: int = 0):
        device = resolve_device(device)
        if auto_fast_serving and compute_dtype != torch.float32:
            # bf16 serving defaults to the fast pair: tanh-GELU blocks (which
            # also routes stages 3-4 through the fused block kernel) and
            # frontend precision "default" (single-pass bf16 DFT/mel
            # products). Each switch applies only to the dataclass-default
            # value; pass auto_fast_serving=False to keep exact-erf/"highest"
            # under bf16. An explicitly-passed default is indistinguishable
            # from the dataclass default here, so say what happened out loud.
            switched = []
            if cfg.block_impl == "xla":
                cfg = dataclasses.replace(cfg, block_impl="xla_approx")
                switched.append("block_impl 'xla' -> 'xla_approx' (tanh GELU)")
            if cfg.frontend.precision == "highest":
                cfg = dataclasses.replace(
                    cfg, frontend=dataclasses.replace(cfg.frontend, precision="default"))
                switched.append("frontend precision 'highest' -> 'default' "
                                "(single-pass bf16 DFT/mel GEMMs)")
            if switched:
                warnings.warn(
                    "bf16 serving auto-switched: " + "; ".join(switched)
                    + ". Pass auto_fast_serving=False to keep the exact "
                    "f32-parity settings under bf16.",
                    stacklevel=2,
                )
        super().__init__(cfg, device=device, seed=seed)
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.device = device
        self.frontend = LogMelFrontend(cfg.frontend, device=device)

    def _waveform(self, waveform) -> torch.Tensor:
        # int16 PCM crosses to the device as int16 and decodes there
        return decode_pcm_if_int16(torch.as_tensor(waveform).to(self.device))

    @torch.inference_mode()
    def forward(self, waveform) -> Dict[str, torch.Tensor]:
        return F.forward(self, self._waveform(waveform), self.cfg, self.frontend,
                         self.compute_dtype)

    @torch.inference_mode()
    def forward_scene_embeddings(self, waveform) -> torch.Tensor:
        return F.forward_scene_embeddings(self, self._waveform(waveform), self.cfg,
                                          self.frontend, self.compute_dtype)

    @torch.inference_mode()
    def forward_frame_embeddings(self, waveform) -> torch.Tensor:
        return F.forward_frame_embeddings(self, self._waveform(waveform), self.cfg,
                                          self.frontend, self.compute_dtype)

    def count_parameters(self) -> int:
        return F.count_parameters(self)

    @classmethod
    def from_pretrained(cls, pretrained_checkpoint_path: str, compute_dtype=torch.float32,
                        cfg: Optional[ConvNeXtConfig] = None, auto_fast_serving: bool = True,
                        device=None) -> "ConvNeXt":
        """Load a local ``.pth``/``.safetensors``/native checkpoint, an https
        URL or a HuggingFace model id (reference convnext.py:404-511). The
        default ``cfg`` is convnext_tiny with the audio stem, as in the JAX
        package; ``strict`` key and shape checks apply."""
        from audioset_convnext_inf_torch.checkpoint.io import load_pretrained

        device = resolve_device(device)
        if cfg is None:
            cfg = ConvNeXtConfig(drop_path_rate=0.0, after_stem_dim=(252, 56))
        sd = load_pretrained(pretrained_checkpoint_path, cfg)
        model = cls(cfg, compute_dtype=compute_dtype, auto_fast_serving=auto_fast_serving,
                    device=device)
        model.load_state_dict(to_tensors(sd), strict=True)
        return model


# ---------------------------------------------------------------------------
# Factories (reference convnext.py:569-901)
# ---------------------------------------------------------------------------

_VARIANTS: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {
    "convnext_atto": ((2, 2, 6, 2), (40, 80, 160, 320)),
    "convnext_femto": ((2, 2, 6, 2), (48, 96, 192, 384)),
    "convnext_pico": ((2, 2, 6, 2), (64, 128, 256, 512)),
    "convnext_nano": ((2, 2, 8, 2), (80, 160, 320, 640)),
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
}


def _make_factory(name: str) -> Callable[..., ConvNeXt]:
    depths, dims = _VARIANTS[name]

    def factory(
        drop_path_rate: float = 0.1,
        after_stem_dim=(252, 56),
        use_speed_perturb: bool = False,
        use_pydub_augment: bool = False,
        use_roll_augment: bool = False,
        seed: int = 0,
        compute_dtype=torch.float32,
        pretrained_imagenet: Optional[str] = None,
        device=None,
        **kwargs,
    ) -> ConvNeXt:
        cfg = ConvNeXtConfig(
            name=name,
            depths=depths,
            dims=dims,
            drop_path_rate=drop_path_rate,
            after_stem_dim=tuple(after_stem_dim),
            augment=AugmentConfig(
                use_speed_perturb=use_speed_perturb,
                use_pydub_augment=use_pydub_augment,
                use_roll_augment=use_roll_augment,
            ),
            **kwargs,
        )
        model = ConvNeXt(cfg, compute_dtype=compute_dtype, device=device, seed=seed)
        if pretrained_imagenet:
            # non-strict ImageNet backbone init with the audio stem, bn0 and
            # head kept (reference convnext.py:663-707); a local image-ConvNeXt .pth
            sd = torch.load(pretrained_imagenet, map_location="cpu", weights_only=True)
            model.load_state_dict(to_tensors(load_imagenet_backbone(sd, cfg, model.state_dict())),
                                  strict=True)
        return model

    factory.__name__ = name
    factory.__doc__ = f"{name}: depths={depths}, dims={dims} (audio stem, 527 classes)."
    return factory


convnext_atto = _make_factory("convnext_atto")
convnext_femto = _make_factory("convnext_femto")
convnext_pico = _make_factory("convnext_pico")
convnext_nano = _make_factory("convnext_nano")
convnext_tiny = _make_factory("convnext_tiny")
convnext_small = _make_factory("convnext_small")
convnext_base = _make_factory("convnext_base")

MODEL_REGISTRY: Dict[str, Callable[..., ConvNeXt]] = {
    "convnext_atto": convnext_atto,
    "convnext_femto": convnext_femto,
    "convnext_pico": convnext_pico,
    "convnext_nano": convnext_nano,
    "convnext_tiny": convnext_tiny,
    "convnext_small": convnext_small,
    "convnext_base": convnext_base,
}


def create_model(name: str, **kwargs) -> ConvNeXt:
    """Dispatch by model-type string (the reference's zoo dispatch,
    main.py:427-543, without ``eval``)."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)
