"""LM sharding on the port: the reference's rules (`rules`) and the
collectives the sharded layers run on local shards (`collectives`)."""
