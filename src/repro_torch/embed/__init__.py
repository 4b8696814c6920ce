"""LM-embedding task features (port of ``src/repro/embed``): a synthetic
text corpus (:mod:`.corpus`), a batched encoder through the port's model
(:mod:`.encoder`) and the dataset / bank builders (:mod:`.bank`)."""
