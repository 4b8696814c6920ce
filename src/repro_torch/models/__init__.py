"""The port's LM stack: parameter templates, layers, the recurrent blocks
(RG-LRU, mLSTM, sLSTM) and the model forward (``attn``, ``rglru``,
``mlstm`` and ``slstm`` blocks, train mode)."""
