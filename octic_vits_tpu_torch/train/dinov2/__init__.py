"""DINOv2 self-supervised training: the losses, the masking and collate, the
schedules, the per-parameter multipliers and the meta-architecture with its
train step (the engine that ``octic_vits_tpu/train/dinov2/train.py`` drives;
its loop, loaders, CLI and checkpoints are not ported yet)."""
