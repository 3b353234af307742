"""Training machinery of the port: the train state, the losses, LAMB, the
DeiT III recipe (``train.deit``) and the DINOv2 recipe (``train.dinov2``),
each with its step, loop and command line."""
