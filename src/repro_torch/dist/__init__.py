"""Distribution substrate of the port (``repro.dist``).

Ported: :mod:`repro_torch.dist.elastic` (remesh verdicts for the serving
fleet and the search) and :mod:`repro_torch.dist.straggler` (the search's
straggler detector); the sharding rules, activation constraints, pipeline
stages and gradient compression are not.  Modules are imported
individually (``from repro_torch.dist import elastic``).
"""
