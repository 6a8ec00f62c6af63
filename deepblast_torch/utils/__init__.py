"""Logging helpers (own copies from ``deepblast_tpu.utils``)."""
