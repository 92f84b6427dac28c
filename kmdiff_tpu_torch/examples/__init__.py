"""Example plugins of kmdiff_tpu_torch (plugins/)."""
