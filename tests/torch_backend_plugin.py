"""An out-of-tree lookup backend for the port's plugin tests.

Importing this module registers ``echo``: a backend that plans and runs
the cascade exactly as the built-in ``take`` does, so its codes are
``take``'s.  The tests load it by naming this module in
``REPRO_TORCH_LUT_BACKEND_PLUGINS``; nothing imports it directly.
"""
from repro_torch import backends
from repro_torch.backends.base import (BackendCapabilities, ExecutionPlan,
                                       LookupBackend)

LOADS = []   # one entry an import: the tests count how often it loaded


@backends.register("echo")
class EchoBackend(LookupBackend):
    """``take``'s plan and cascade under another name."""

    name = "echo"

    def capabilities(self):
        return BackendCapabilities(name="echo", fused=False,
                                   needs_pallas=False)

    def plan(self, net):
        inner = backends.make_plan(net, backends.get("take"))
        return ExecutionPlan(backend="echo", meta=inner.meta,
                             buffers=inner.buffers)

    def run(self, plan, codes):
        return backends.get("take").run(plan, codes)


LOADS.append(1)
