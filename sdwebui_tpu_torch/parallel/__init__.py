"""The parallel runtime: the device mesh, its collectives, the tensor-parallel
sharding rules, ring attention and the row-sharded VAE."""
