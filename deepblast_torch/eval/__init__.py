"""Alignment-accuracy statistics and structural metrics (own copies from
``deepblast_tpu.eval``)."""
