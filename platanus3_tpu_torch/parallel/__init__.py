"""Sharding over ranks of ``torch.distributed``: the mesh, the collectives,
the hash-prefix-sharded stage 1 and the multi-process helpers."""
