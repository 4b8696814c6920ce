"""Training (port of ``src/repro/training``): AdamW with the cosine
schedule, npz checkpoints interchangeable with the reference's, and the
fault-tolerant trainer on one device or a mesh."""
