"""Ranks on ``torch.distributed``: the (data, model, time) mesh and channel
sharding (``mesh.py``), the time-sharded stream (``halo.py``) and the
multi-rank dryrun (``dryrun.py``)."""
