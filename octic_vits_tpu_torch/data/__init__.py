"""The training recipes' data: image datasets, samplers, host transforms
(PIL + numpy, with the native host library), the prefetching loader, and the
on-device mixup/cutmix. PIL is imported where an image is decoded."""

from octic_vits_tpu_torch.data.mixup import MixDraws, draw_mixup, mixup_cutmix, one_hot_smooth

__all__ = ["MixDraws", "draw_mixup", "mixup_cutmix", "one_hot_smooth"]
