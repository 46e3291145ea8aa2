"""Launchers: ``python -m repro_torch.launch.serve`` (the port of
``repro.launch``'s serving launcher)."""
