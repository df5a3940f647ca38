"""Command-line entry points of the port (python -m rohm_tpu_torch.cli.<name>)."""
