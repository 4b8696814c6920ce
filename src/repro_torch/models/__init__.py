"""The port's LM stack: parameter templates, layers (attention, MLP, MoE),
the recurrent blocks (RG-LRU, mLSTM, sLSTM), the model forward in train,
prefill and decode mode with its caches, on one device or a mesh, and the
step functions."""
