"""repro_torch.launch — drivers (``python -m repro_torch.launch.serve``)."""
