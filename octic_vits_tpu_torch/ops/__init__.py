"""Ops on tensors. Each kernel op launches a hand-written CUDA kernel for
CUDA tensors and runs its ``*_reference`` plain version for CPU tensors;
``<op>.launches`` counts its kernel launches."""

from octic_vits_tpu_torch.ops.attention import (
    attention_bwd_plan,
    octic_attention,
    octic_attention_bwd,
    octic_attention_bwd_reference,
    octic_attention_fused_qkv,
    octic_attention_fused_qkv_bwd,
    octic_attention_fused_qkv_bwd_reference,
    octic_attention_fused_qkv_packed,
    octic_attention_fused_qkv_packed_bwd,
    octic_attention_fused_qkv_packed_bwd_reference,
    octic_attention_fused_qkv_packed_reference,
    octic_attention_fused_qkv_reference,
    octic_attention_reference,
    octic_attention_wide,
    octic_attention_wide1d,
    octic_attention_wide1d_bwd,
    octic_attention_wide1d_bwd_reference,
    octic_attention_wide1d_reference,
    octic_attention_wide_bwd,
    octic_attention_wide_bwd_reference,
    octic_attention_plan,
    octic_attention_wide_reference,
    standard_attention,
    standard_attention_bwd,
    standard_attention_bwd_reference,
    standard_attention_reference,
)
from octic_vits_tpu_torch.ops.attention_probe import (
    PROBE_OPS_14A,
    aligned_all_attention,
    aligned_cheap_attention,
    aligned_loads_attention,
    aligned_nosm_attention,
    bh_octic_attention,
    bh_std_attention,
    cls_split_attention,
    cls_split_octic_attention,
    full_attention,
    headmajor_attention,
    headmajor_attention_bwd,
    hoist_assembly,
    hoist_octic_attention,
    interleave2_attention,
    multi_image_attention,
    multi_image_octic_attention,
    padded_attention,
    padded_octic_attention,
    phased_attention,
    scores_only_attention,
    scores_softmax_attention,
    whole_head_octic_attention,
)
from octic_vits_tpu_torch.ops.attention_probe import EXPERIMENT_OPS
from octic_vits_tpu_torch.ops.attention_bwd_probe import (
    PROBE_OPS_14C,
    octic_attention_bwd_wideg,
    octic_attention_bwd_widestore,
    octic_group_attention,
    octic_group_attention_bwd,
    octic_qkv_attention,
    octic_qkv_attention_proj,
    std_maskpair_attention,
    std_maskpair_attention_bwd,
    std_pack_attention,
    std_pack_attention_bwd,
)
from octic_vits_tpu_torch.ops.dense import dense_gelu, dense_gelu_bwd, dense_gelu_reference
from octic_vits_tpu_torch.ops.gelu_d8 import (
    gelu_d8,
    gelu_d8_bwd,
    gelu_d8_bwd_reference,
    gelu_d8_eager,
    gelu_d8_reference,
    gelu_d8_vjp,
    gelu_exact,
    gelu_grad,
)
from octic_vits_tpu_torch.ops.linear import (
    lin_d8_bwd_launch,
    lin_d8_launch,
    lin_d8_plan,
    lin_d8_bwd_reference,
    linear_d8,
    linear_d8_epilogue,
    linear_d8_fused,
    linear_d8_fused_bwd,
    linear_d8_fused_reference,
    linear_d8_qkv_wide,
    linear_d8_qkv_wide_reference,
    linear_d8_tuple,
    linear_d8_wide1d,
    linear_d8_wide1d_reference,
    mlp_d8_fused,
    mlp_d8_fused_bwd,
    mlp_d8_fused_bwd_reference,
    mlp_d8_fused_packed,
    mlp_d8_fused_packed_reference,
    mlp_d8_fused_reference,
    mlp_d8_packed,
    uninterleave_wide,
)
from octic_vits_tpu_torch.ops.linear_probe import lin_d8_sync, lin_d8_tiled
from octic_vits_tpu_torch.ops.ln_d8 import (
    ln_affine_d8_bwd,
    ln_affine_d8_bwd_reference,
    ln_affine_d8_flat_tuple,
    ln_affine_d8_reference,
    ln_d8_bwd,
    ln_d8_bwd_reference,
    ln_d8_flat_tuple,
    ln_d8_reference,
)
from octic_vits_tpu_torch.ops.mlp_branch import (
    mlp_branch_d8,
    mlp_branch_d8_reference,
    mlp_branch_eager,
)
from octic_vits_tpu_torch.ops.mma_probe import matmul_law, matmul_law_batched

#: the four kernel ops of the inference path
INFERENCE_OPS = (standard_attention, octic_attention_fused_qkv, dense_gelu, mlp_d8_fused)
#: the octic block's fused-glue ops: the D8 LayerNorm (with and without
#: the affine, forward and backward), the D8-GELU (forward and backward),
#: the launches of linear_d8_fused with the LayerScale + residual epilogue,
#: and the fused MLP branch
GLUE_OPS = (ln_affine_d8_flat_tuple, ln_affine_d8_bwd, ln_d8_flat_tuple, ln_d8_bwd, gelu_d8,
            gelu_d8_bwd, linear_d8_epilogue, mlp_branch_d8)
#: the packed-carry ops: the fused qkv + attention on the packed container
#: (row 10) and its backward, and the fused MLP on it (row 11), whose
#: backward counts under mlp_d8_fused_bwd (row 4's backward)
PACKED_OPS = (octic_attention_fused_qkv_packed, octic_attention_fused_qkv_packed_bwd,
              mlp_d8_fused_packed)
#: the wide-qkv ops: the wide-1d octic attention (row 12) and its backward,
#: with the wide-1d qkv product that feeds it (AttentionD8(use_wide_qkv));
#: the octic attention over one interleaved qkv (row 13a) and its backward,
#: with the qkv product that stores that layout (row 13b)
WIDE_OPS = (octic_attention_wide1d, octic_attention_wide1d_bwd, linear_d8_wide1d,
            octic_attention_wide, octic_attention_wide_bwd, linear_d8_qkv_wide)
#: the probes of kernel row 14b: the attention probes of
#: scripts/r3_attn_experiments.py, K-lin-d8's tile sweep
#: (scripts/profile_lin_tiles.py) and the product-cost law
#: (scripts/r3_matmul_law.py)
PROBE_OPS_14B = EXPERIMENT_OPS + (lin_d8_tiled, matmul_law, matmul_law_batched)
#: every probe op (kernel rows 14a, 14b and 14c, the last the probes of
#: scripts/r3_attn_bwd_ablate.py); each one's plain version is also
#: ``<op>.reference``
#: the kernels the Hopper redesigns replaced on the model paths, kept as the
#: yardsticks they are timed against: K-lin-d8's mma.sync core and K-attn's
#: whole-head octic core
PARENT_OPS = (lin_d8_sync, whole_head_octic_attention)
PROBE_OPS = PROBE_OPS_14A + PROBE_OPS_14B + PROBE_OPS_14C + PARENT_OPS
#: every kernel op, each with its own launch counter (the DeiT III train path
#: runs standard_attention, its backward, octic_attention, its backward,
#: linear_d8_fused and dense_gelu; the DINOv2 step adds the backward of the
#: fused qkv + attention; fuse_mlp training adds the fused MLP's backward;
#: the probes of kernel rows 14a-14c run on no model path).
KERNEL_OPS = INFERENCE_OPS + (standard_attention_bwd, octic_attention, octic_attention_bwd,
                              linear_d8_fused, octic_attention_fused_qkv_bwd,
                              mlp_d8_fused_bwd) + GLUE_OPS + PACKED_OPS + WIDE_OPS + PROBE_OPS


def reset_launch_counts() -> None:
    for op in KERNEL_OPS:
        op.launches = 0


def launch_counts() -> dict:
    return {op.__name__: op.launches for op in KERNEL_OPS}


__all__ = [
    "attention_bwd_plan",
    "lin_d8_plan",
    "octic_attention_plan",
    "GLUE_OPS",
    "INFERENCE_OPS",
    "KERNEL_OPS",
    "PACKED_OPS",
    "PROBE_OPS",
    "PROBE_OPS_14A",
    "PROBE_OPS_14B",
    "PROBE_OPS_14C",
    "WIDE_OPS",
    "aligned_all_attention",
    "aligned_cheap_attention",
    "aligned_loads_attention",
    "aligned_nosm_attention",
    "bh_octic_attention",
    "bh_std_attention",
    "cls_split_attention",
    "cls_split_octic_attention",
    "full_attention",
    "headmajor_attention",
    "headmajor_attention_bwd",
    "hoist_assembly",
    "hoist_octic_attention",
    "interleave2_attention",
    "lin_d8_sync",
    "lin_d8_tiled",
    "matmul_law",
    "matmul_law_batched",
    "multi_image_attention",
    "multi_image_octic_attention",
    "padded_attention",
    "padded_octic_attention",
    "phased_attention",
    "scores_only_attention",
    "scores_softmax_attention",
    "dense_gelu",
    "dense_gelu_bwd",
    "dense_gelu_reference",
    "gelu_d8",
    "gelu_d8_bwd",
    "gelu_d8_bwd_reference",
    "gelu_d8_eager",
    "gelu_d8_reference",
    "gelu_d8_vjp",
    "gelu_exact",
    "gelu_grad",
    "launch_counts",
    "lin_d8_bwd_launch",
    "lin_d8_launch",
    "lin_d8_bwd_reference",
    "linear_d8",
    "linear_d8_epilogue",
    "linear_d8_fused",
    "linear_d8_fused_bwd",
    "linear_d8_fused_reference",
    "linear_d8_qkv_wide",
    "linear_d8_qkv_wide_reference",
    "linear_d8_tuple",
    "linear_d8_wide1d",
    "linear_d8_wide1d_reference",
    "ln_affine_d8_bwd",
    "ln_affine_d8_bwd_reference",
    "ln_affine_d8_flat_tuple",
    "ln_affine_d8_reference",
    "ln_d8_bwd",
    "ln_d8_bwd_reference",
    "ln_d8_flat_tuple",
    "ln_d8_reference",
    "mlp_branch_d8",
    "mlp_branch_d8_reference",
    "mlp_branch_eager",
    "mlp_d8_fused",
    "mlp_d8_fused_bwd",
    "mlp_d8_fused_bwd_reference",
    "mlp_d8_fused_packed",
    "mlp_d8_fused_packed_reference",
    "mlp_d8_fused_reference",
    "mlp_d8_packed",
    "octic_attention",
    "octic_attention_bwd",
    "octic_attention_bwd_reference",
    "octic_attention_fused_qkv",
    "octic_attention_fused_qkv_bwd",
    "octic_attention_fused_qkv_bwd_reference",
    "octic_attention_fused_qkv_packed",
    "octic_attention_fused_qkv_packed_bwd",
    "octic_attention_fused_qkv_packed_bwd_reference",
    "octic_attention_fused_qkv_packed_reference",
    "octic_attention_fused_qkv_reference",
    "octic_attention_reference",
    "octic_attention_wide",
    "octic_attention_wide1d",
    "octic_attention_wide1d_bwd",
    "octic_attention_wide1d_bwd_reference",
    "octic_attention_wide1d_reference",
    "octic_attention_wide_bwd",
    "octic_attention_wide_bwd_reference",
    "octic_attention_wide_reference",
    "octic_attention_bwd_wideg",
    "octic_attention_bwd_widestore",
    "octic_group_attention",
    "octic_group_attention_bwd",
    "octic_qkv_attention",
    "octic_qkv_attention_proj",
    "std_maskpair_attention",
    "std_maskpair_attention_bwd",
    "std_pack_attention",
    "std_pack_attention_bwd",
    "reset_launch_counts",
    "standard_attention",
    "standard_attention_bwd",
    "standard_attention_bwd_reference",
    "standard_attention_reference",
    "uninterleave_wide",
    "whole_head_octic_attention",
]
