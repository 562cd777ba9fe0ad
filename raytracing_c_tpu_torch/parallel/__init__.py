"""Multi-device rendering over torch.distributed, one process per device:
`mesh.py` (the group, scene replication, ray shards, the two collectives)
and `launch.py` (starting the ranks from one process)."""
