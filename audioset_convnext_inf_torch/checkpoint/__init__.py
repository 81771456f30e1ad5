"""Weight carry from the JAX package's parameter pytree."""

from audioset_convnext_inf_torch.checkpoint.convert import state_dict_from_jax_params, to_tensors

__all__ = ["state_dict_from_jax_params", "to_tensors"]
