"""repro_torch.launch — entry points (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.dryrun``), the production meshes and sharding rules
(``mesh``) and the dry run's accounting (``analysis``)."""
