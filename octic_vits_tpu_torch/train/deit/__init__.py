"""DeiT III supervised training: the config, the schedule, the optimizer and
the train and eval steps (``engine``), the loop with its evaluation,
checkpoints and resume (``main``) and the command line (``cli``)."""
