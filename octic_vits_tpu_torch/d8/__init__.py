"""D8 group algebra on torch tensors (no parameters)."""

from octic_vits_tpu_torch.d8.group import (
    SQRT2,
    SQRT2_OVER_2,
    SQRT2_OVER_4,
    isotypic_to_regular,
    pack_8_to_5,
    pack_8_to_5f,
    regular_to_isotypic,
    unpack_5_to_8,
    unpack_5f_to_8,
)
from octic_vits_tpu_torch.d8.posembed import resize_grid, resize_posembed, unfold_quadrant

__all__ = [
    "SQRT2",
    "SQRT2_OVER_2",
    "SQRT2_OVER_4",
    "isotypic_to_regular",
    "pack_8_to_5",
    "pack_8_to_5f",
    "regular_to_isotypic",
    "resize_grid",
    "resize_posembed",
    "unfold_quadrant",
    "unpack_5_to_8",
    "unpack_5f_to_8",
]
