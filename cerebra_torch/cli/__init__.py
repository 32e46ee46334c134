"""Command-line entry points (`python -m cerebra_torch.cli.<name>`)."""
