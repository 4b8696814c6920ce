"""Seconds from the start of the benchmark's process to the start of the
window: imports, kernel builds (or the build cache), weights drawn, the
cell's shapes warmed up."""


def read(run):
    return run.get("setup_s")
