"""Launchers: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``, and the steps they run
(``launch.steps``; the port of ``repro.launch``'s serving and training
launchers)."""
