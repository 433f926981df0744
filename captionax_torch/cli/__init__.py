"""Command-line entry points of the port: ``python -m captionax_torch.cli.<name>``."""
