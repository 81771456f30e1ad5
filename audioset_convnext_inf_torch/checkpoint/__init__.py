"""Checkpoints: reference state dicts (.pth, .safetensors), native
checkpoint directories, and the weight carry from the JAX package's pytree."""

from audioset_convnext_inf_torch.checkpoint.convert import (
    jax_params_from_state_dict,
    load_imagenet_backbone,
    load_reference_state_dict,
    state_dict_from_jax_params,
    to_tensors,
)
from audioset_convnext_inf_torch.checkpoint.io import (
    load_checkpoint,
    load_pretrained,
    optimizer_state_from_optax,
    optimizer_state_to_optax,
    read_safetensors,
    save_checkpoint,
    save_safetensors,
)

__all__ = [
    "jax_params_from_state_dict",
    "load_checkpoint",
    "load_imagenet_backbone",
    "load_pretrained",
    "load_reference_state_dict",
    "optimizer_state_from_optax",
    "optimizer_state_to_optax",
    "read_safetensors",
    "save_checkpoint",
    "save_safetensors",
    "state_dict_from_jax_params",
    "to_tensors",
]
