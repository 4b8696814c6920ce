"""Command-line launchers of the port (``python -m
repro_torch.launch.train``), the device meshes (:mod:`.mesh`) and the
abstract specs of every workload cell (:mod:`.specs`)."""
