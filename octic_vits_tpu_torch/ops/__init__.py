"""Ops on tensors. Each kernel op launches a hand-written CUDA kernel for
CUDA tensors and runs its ``*_reference`` plain version for CPU tensors;
``<op>.launches`` counts its kernel launches."""

from octic_vits_tpu_torch.ops.attention import (
    octic_attention_fused_qkv,
    octic_attention_fused_qkv_reference,
    standard_attention,
    standard_attention_reference,
)
from octic_vits_tpu_torch.ops.dense import dense_gelu, dense_gelu_reference
from octic_vits_tpu_torch.ops.gelu_d8 import gelu_d8_eager, gelu_exact
from octic_vits_tpu_torch.ops.linear import linear_d8, mlp_d8_fused, mlp_d8_fused_reference

#: the four kernel ops of the inference slice
KERNEL_OPS = (standard_attention, octic_attention_fused_qkv, dense_gelu, mlp_d8_fused)


def reset_launch_counts() -> None:
    for op in KERNEL_OPS:
        op.launches = 0


__all__ = [
    "KERNEL_OPS",
    "dense_gelu",
    "dense_gelu_reference",
    "gelu_d8_eager",
    "gelu_exact",
    "linear_d8",
    "mlp_d8_fused",
    "mlp_d8_fused_reference",
    "octic_attention_fused_qkv",
    "octic_attention_fused_qkv_reference",
    "reset_launch_counts",
    "standard_attention",
    "standard_attention_reference",
]
