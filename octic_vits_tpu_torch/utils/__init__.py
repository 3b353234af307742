"""Utilities: weights carried across from the JAX package."""

from octic_vits_tpu_torch.utils.convert import params_from_jax

__all__ = ["params_from_jax"]
