"""iBOT block-wise masking and the static-shape collate, on the host in numpy
(the port's own copy of octic_vits_tpu/train/dinov2/masking.py).

The masked-token index list is padded to ``mask_upperbound``, which depends
only on the configuration, so every step sees buffers of the same shape.
The same ``random.Random`` seed draws the same masks as the JAX package.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Tuple

import numpy as np


class MaskingGenerator:
    """Random rectangular blocks on a ``height x width`` patch grid until the
    requested number of patches is masked (or no block fits)."""

    def __init__(self, input_size, num_masking_patches=None, min_num_patches=4,
                 max_num_patches=None, min_aspect=0.3, max_aspect=None):
        if not isinstance(input_size, tuple):
            input_size = (input_size,) * 2
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.min_num_patches = min_num_patches
        self.max_num_patches = num_masking_patches if max_num_patches is None else max_num_patches
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def _place_block(self, mask: np.ndarray, max_mask_patches, rng: random.Random) -> int:
        delta = 0
        for _ in range(10):
            target_area = rng.uniform(self.min_num_patches, max_mask_patches)
            aspect = math.exp(rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect)))
            w = int(round(math.sqrt(target_area / aspect)))
            if w < self.width and h < self.height:
                top = rng.randint(0, self.height - h)
                left = rng.randint(0, self.width - w)
                region = mask[top:top + h, left:left + w]
                if 0 < h * w - int(region.sum()) <= max_mask_patches:
                    delta = int((~region).sum())
                    region[:] = True
                if delta > 0:
                    break
        return delta

    def __call__(self, num_masking_patches=0, rng: random.Random = random) -> np.ndarray:
        mask = np.zeros((self.height, self.width), dtype=bool)
        count = 0
        while count < num_masking_patches:
            max_mask = min(num_masking_patches - count, self.max_num_patches or 1e9)
            delta = self._place_block(mask, max_mask, rng)
            if delta == 0:
                break
            count += delta
        return mask


def mask_upperbound(batch_size: int, n_tokens: int, mask_probability: float,
                    mask_ratio_tuple: Tuple[float, float]) -> int:
    """The padding bound of the masked-token buffer: the most tokens the
    collate can mask for this configuration."""
    n_masked = int(batch_size * mask_probability)
    probs = np.linspace(*mask_ratio_tuple, n_masked + 1)
    return int(sum(int(n_tokens * probs[i + 1]) for i in range(n_masked)))


def collate_crops_and_masks(global_crops: np.ndarray, local_crops: np.ndarray, n_tokens: int,
                            mask_generator: MaskingGenerator, mask_probability: float = 0.5,
                            mask_ratio_tuple: Tuple[float, float] = (0.1, 0.5),
                            rng: random.Random = random,
                            dtype=np.float32) -> Dict[str, np.ndarray]:
    """Crops (crop-major: ``[2B, S, S, 3]``, ``[nl B, s, s, 3]``) -> the SSL
    batch: masks ``[2B, N]`` for a `mask_probability` share of the global
    crops, the flat indices of the masked tokens and their per-image weights
    padded to :func:`mask_upperbound`, and the count of masked tokens."""
    b = len(global_crops)
    n_samples_masked = int(b * mask_probability)
    probs = np.linspace(*mask_ratio_tuple, n_samples_masked + 1)
    upperbound = mask_upperbound(b, n_tokens, mask_probability, mask_ratio_tuple)

    masks_list: List[np.ndarray] = []
    for i in range(n_samples_masked):
        target = int(n_tokens * rng.uniform(probs[i], probs[i + 1]))
        masks_list.append(mask_generator(target, rng=rng).flatten())
    for _ in range(n_samples_masked, b):
        masks_list.append(np.zeros(n_tokens, dtype=bool))
    rng.shuffle(masks_list)

    masks = np.stack(masks_list)
    return {
        "global_crops": global_crops.astype(dtype),
        "local_crops": local_crops.astype(dtype),
        "masks": masks,
        **shard_masked_buffers(masks, upperbound),
    }


def shard_masked_buffers(masks: np.ndarray, length: int) -> Dict[str, np.ndarray]:
    """The masked-token buffers of `masks` ``[2B, N]`` padded to `length`:
    the flat indices of the masked tokens, each one's weight (1 / its
    image's count of masked tokens; 0 on the padding) and their count. Of a
    process's rows of a global batch, padded to the global buffer's length."""
    masks = np.asarray(masks)
    flat_idx = np.nonzero(masks.flatten())[0].astype(np.int32)
    n_masked = len(flat_idx)
    if n_masked > length:
        raise AssertionError(f"{n_masked} masked tokens above the bound {length}")
    mask_indices = np.zeros(length, dtype=np.int32)
    mask_indices[:n_masked] = flat_idx
    per_img_weight = 1.0 / np.clip(masks.sum(-1), 1.0, None)
    weights = np.repeat(per_img_weight, masks.sum(-1).astype(np.int64))
    masks_weight = np.zeros(length, dtype=np.float32)
    masks_weight[:n_masked] = weights
    return {"mask_indices": mask_indices, "masks_weight": masks_weight,
            "n_masked_patches": np.asarray(n_masked, np.int32)}
