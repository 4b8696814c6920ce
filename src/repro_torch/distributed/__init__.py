"""Distributed helpers of the port: the shard groups of the sharded
labeling service (:mod:`.sharding`), the gradient compression that
``TrainConfig.compression`` needs (:mod:`.compression`) and the host-side
elastic monitor (:mod:`.elastic`). The LM stack's parameter sharding rules
are not ported (ROADMAP A13b)."""
