"""Distribution substrate of the port (``repro.dist``).

Only :mod:`repro_torch.dist.elastic` (remesh verdicts for the serving
fleet and the search) is ported; the sharding rules, activation
constraints, pipeline stages, gradient compression and straggler handling
are not.  Modules are imported individually (``from repro_torch.dist
import elastic``).
"""
