"""Alignment-accuracy statistics (own copies from ``deepblast_tpu.eval``)."""
