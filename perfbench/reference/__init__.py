"""Plain references that decide ``correct``: they import nothing of the
program (``repro_torch``), of ``jax`` or of the JAX package."""
