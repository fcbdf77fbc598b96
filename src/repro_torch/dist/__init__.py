"""Distribution substrate of the port (``repro.dist``): sharding rules
(:mod:`~repro_torch.dist.sharding`), activation constraints
(:mod:`~repro_torch.dist.act_sharding`),
GPipe (:mod:`~repro_torch.dist.pipeline`), int8 gradient compression
(:mod:`~repro_torch.dist.compress`), remesh verdicts for the serving fleet
and the search (:mod:`~repro_torch.dist.elastic`) and the search's
straggler detector (:mod:`~repro_torch.dist.straggler`).

Modules are imported individually (``from repro_torch.dist import
sharding``); importing one starts no process group.
"""
