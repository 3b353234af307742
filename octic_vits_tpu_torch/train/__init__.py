"""Training machinery of the port: the train state, the losses, LAMB, and
the DeiT III supervised step (``train.deit``)."""
