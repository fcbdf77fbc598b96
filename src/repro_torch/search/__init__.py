"""Hardware-aware assembly search (the port of ``repro.search``).

Explores (fan-in, unit widths, subnet depth, beta/mixed precision, skip
placement) candidates of a registered task, trains them in stacked groups
with successive halving, and promotes Pareto survivors to full Toolflow
training, returning a ranked frontier of deployable `CompiledLUTNetwork`
artifacts scored by calibrated area-delay product.

    from repro_torch.pipeline import Toolflow
    from repro_torch.search import SearchBudget
    result = Toolflow.search("nid_reduced", SearchBudget.smoke(),
                             device="cpu")      # CUDA without device=
    for p in result.frontier:
        print(p.name, p.accuracy, p.luts, p.adp)
        p.compiled.save(f"frontier_{p.name}.npz")
"""
from repro_torch.search.driver import (DistributedSearchBudget, FrontierPoint,
                                       SearchResult, pareto_frontier,
                                       pareto_order, run_search)
from repro_torch.search.space import (Candidate, SearchBudget,
                                      generate_candidates, round_and_validate,
                                      shape_signature, validate)

__all__ = [
    "Candidate", "DistributedSearchBudget", "FrontierPoint", "SearchBudget",
    "SearchResult", "generate_candidates", "pareto_frontier", "pareto_order",
    "round_and_validate", "run_search", "shape_signature", "validate",
]
