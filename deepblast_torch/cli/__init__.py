"""Command-line entry points, run as ``python -m deepblast_torch.cli.<name>``."""
