"""Distributed-training helpers of the port: only the gradient compression
that ``TrainConfig.compression`` needs (see :mod:`.compression`); sharding
and elastic eviction are not ported."""
