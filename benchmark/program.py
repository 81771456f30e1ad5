"""The program under test, built from a configuration file.

The only module of the benchmark that imports the PyTorch port, and it
does so inside its functions. A configuration file's ``model`` holds the
published shapes (shared with the reference), ``program`` the port's
settings (compute dtype, block implementation, frontend precision, fused
training blocks) and, for training, ``train`` the optimizer's.
"""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(cfg: dict):
    from audioset_convnext_inf_torch.config import (
        AugmentConfig,
        ConvNeXtConfig,
        FrontendConfig,
        SpecAugmentConfig,
    )

    m, p = cfg["model"], cfg["program"]
    fe = m["frontend"]
    frontend = FrontendConfig(
        sample_rate=fe["sample_rate"], n_fft=fe["n_fft"], win_length=fe["win_length"],
        hop_length=fe["hop_length"], n_mels=fe["n_mels"], fmin=fe["fmin"], fmax=fe["fmax"],
        amin=fe["amin"], ref=fe["ref"], precision=p["frontend_precision"],
        dft_impl=p["dft_impl"])
    augment = AugmentConfig(use_spec_augment=True,
                            spec_augment=SpecAugmentConfig(**m["spec_augment"]),
                            mixup_alpha=cfg.get("train", {}).get("mixup_alpha", 0.0))
    return ConvNeXtConfig(
        name=m["name"], depths=tuple(m["depths"]), dims=tuple(m["dims"]),
        num_classes=m["num_classes"], drop_path_rate=m["drop_path_rate"],
        after_stem_dim=tuple(m["after_stem_dim"]), ln_eps=m["ln_eps"], bn_eps=m["bn_eps"],
        block_impl=p["block_impl"], fused_train_blocks=p["fused_train_blocks"],
        frontend=frontend, augment=augment)


def build_model(cfg: dict, state_dict: Dict[str, torch.Tensor], device):
    """The port's ``ConvNeXt`` with the configuration as stated (no
    automatic switches) and the benchmark's weights."""
    from audioset_convnext_inf_torch.models.api import ConvNeXt

    model = ConvNeXt(port_config(cfg), compute_dtype=DTYPES[cfg["program"]["compute_dtype"]],
                     auto_fast_serving=False, device=device)
    model.load_state_dict(state_dict, strict=True)
    return model


def train_config(cfg: dict, seed: int):
    from audioset_convnext_inf_torch.engine.trainer import TrainConfig

    t = cfg["train"]
    return TrainConfig(optimizer=t["optimizer"], max_lr=t["max_lr"], total_steps=t["total_steps"],
                       pct_start=t["pct_start"], div_factor=t["div_factor"],
                       final_div_factor=t["final_div_factor"], weight_decay=t["weight_decay"],
                       mixup_alpha=t["mixup_alpha"], seed=seed,
                       bf16_compute=cfg["program"]["compute_dtype"] == "bfloat16")
