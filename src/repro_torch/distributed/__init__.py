"""Distributed-training helpers of the port: the gradient compression that
``TrainConfig.compression`` needs (:mod:`.compression`) and the host-side
elastic monitor (:mod:`.elastic`); sharding is not ported (ROADMAP A13)."""
