"""Launchers: ``python -m repro_torch.launch.serve``, ``.train``,
``.dryrun`` and ``.analyze``, the steps they run (``launch.steps``), the
op-level cost model (``launch.op_cost``), the roofline terms at one
H100's constants (``launch.roofline``) and the meshes (``launch.mesh``:
one device, or the data-parallel axes across processes): the port of
``repro.launch``."""
