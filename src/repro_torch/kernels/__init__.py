"""Hand-written Hopper kernels of the port, each beside its plain version
in :mod:`repro_torch.kernels.ref`."""
