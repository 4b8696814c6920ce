"""The port's LM stack: parameter templates, layers, the RG-LRU block and
the model forward (``attn`` and ``rglru`` blocks, train mode)."""
