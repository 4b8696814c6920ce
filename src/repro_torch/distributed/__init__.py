"""Distributed helpers of the port: the sharding rules of the LM stack on
a mesh and the shard groups of the sharded labeling service
(:mod:`.sharding`), the gradient compression that
``TrainConfig.compression`` needs (:mod:`.compression`) and the host-side
elastic monitor (:mod:`.elastic`)."""
