"""The evaluation command lines of the port (counterparts of the JAX
package's scripts/eval_dinov2.py and scripts/eval_segmentation.py), each run
as ``python -m octic_vits_tpu_torch.scripts.<name>`` or called in-process
through its ``main(argv)``."""
