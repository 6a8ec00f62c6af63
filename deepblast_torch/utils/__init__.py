"""Logging, timing and profiling helpers (own copies from
``deepblast_tpu.utils``)."""
