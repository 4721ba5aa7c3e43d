"""Command-line entry points: ``python -m dgraph_tpu_torch.cli.server``."""
