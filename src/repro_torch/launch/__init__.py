"""Launchers: `python -m repro_torch.launch.train`, the legacy training
entry over the Engine CLI."""
