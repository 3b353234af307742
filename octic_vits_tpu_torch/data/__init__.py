"""On-device batch transforms of the training recipes."""

from octic_vits_tpu_torch.data.mixup import MixDraws, draw_mixup, mixup_cutmix, one_hot_smooth

__all__ = ["MixDraws", "draw_mixup", "mixup_cutmix", "one_hot_smooth"]
