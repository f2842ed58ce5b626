"""Multi-GPU: process groups, the device mesh, the batch split, the
gathers of the global-batch losses (``mesh.py``) and the parameter
sharding rules, FSDP2 and tensor parallelism (``sharding_rules.py``)."""
