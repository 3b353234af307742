"""DeiT III supervised training: the config, the schedule, the optimizer and
the train and eval steps (the engine that ``octic_vits_tpu/train/deit/main.py``
wires up; its loop, loaders and checkpoints are not ported yet)."""
