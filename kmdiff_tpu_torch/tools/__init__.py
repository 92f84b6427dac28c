"""Measurement scripts for the port's kernels, run on a CUDA card from the
root of a checkout with ``python3 -m kmdiff_tpu_torch.tools.<name>``."""
