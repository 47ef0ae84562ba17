"""repro_torch.analysis — the ``@contract`` declarations of the D4M entry
points, recorded (:mod:`~repro_torch.analysis.contracts`).  Checking them
is module step 8."""
from .contracts import CONTRACT_ATTR, CONTRACT_REGISTRY, Contract, contract

__all__ = ["CONTRACT_ATTR", "CONTRACT_REGISTRY", "Contract", "contract"]
