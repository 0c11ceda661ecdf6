"""Command-line entry points: ``python -m ripor_tpu_torch.cli.main``."""
