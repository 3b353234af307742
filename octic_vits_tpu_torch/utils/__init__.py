"""Utilities: weights carried across from the JAX package (``convert``),
checkpoints, finetuning, the config system, metric logging and the analytic
MAC counts (``flops``)."""

from octic_vits_tpu_torch.utils.convert import params_from_jax

__all__ = ["params_from_jax"]
