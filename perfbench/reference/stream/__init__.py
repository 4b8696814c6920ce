"""The reference of the stream cells: the tick of the two stream
configurations on the CPU in plain PyTorch (the E-step is the plain
version, no kernel), cut from a frozen copy of the program's
``labelstream``, ``core/simfast.py`` and ``learning`` modules. It draws each
sampled replication's start and arrivals from the seed as the program
does, and reruns it. Not an independent implementation: see PERF.md."""
