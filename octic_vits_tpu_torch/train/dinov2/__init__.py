"""DINOv2 self-supervised training: the losses, the masking and collate, the
schedules, the per-parameter multipliers, the meta-architecture with its
train step, the loop with its checkpoints and teacher exports (``train``)
and the command line (``cli``)."""
