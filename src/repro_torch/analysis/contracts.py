"""``@contract`` — declared performance invariants, recorded.

The decorator attaches a :class:`Contract` to a public API function and
registers it by qualified name, with the fields and defaults of the JAX
package's ``repro.analysis.contracts``::

    @contract(collectives=0, densify=False, name="serve.execute")
    def serve_execute(expr): ...

* ``collectives=N`` — the collectives the entry point makes (``None``:
  undeclared);
* ``host_transfers=N`` — host round trips (``None``: undeclared);
* ``densify=False`` — no intermediate beyond the dense budget
  (``dense_budget`` elements if given).

Here the declaration is only recorded: the function is returned
unchanged, and nothing checks it.  The JAX package verifies contracts by
walking the HLO of the lowered program, which has no torch counterpart;
the port counts its collectives at run time instead
(:mod:`repro_torch.core.collectives`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["CONTRACT_ATTR", "CONTRACT_REGISTRY", "Contract", "contract"]

CONTRACT_ATTR = "__d4m_contract__"

#: qualified entry name -> Contract
CONTRACT_REGISTRY: Dict[str, "Contract"] = {}


@dataclasses.dataclass(frozen=True)
class Contract:
    """Declared invariants for one API entry point."""
    name: str                                 # registry key (qualname)
    collectives: Optional[int] = None         # exact count
    host_transfers: Optional[int] = 0         # exact count (None=undeclared)
    densify: bool = False                     # True = allowed to densify
    dense_budget: Optional[int] = None        # elems; None = derived default
    note: str = ""                            # one-liner for reports


def contract(collectives: Optional[int] = None,
             host_transfers: Optional[int] = 0,
             densify: bool = False,
             dense_budget: Optional[int] = None,
             note: str = "",
             name: Optional[str] = None):
    """Declare invariants on an API entry point: store a
    :class:`Contract` on it (``CONTRACT_ATTR``) and in
    :data:`CONTRACT_REGISTRY`; returns ``fn`` unchanged."""
    def deco(fn):
        key = name or getattr(fn, "__qualname__", fn.__name__)
        c = Contract(name=key, collectives=collectives,
                     host_transfers=host_transfers, densify=densify,
                     dense_budget=dense_budget, note=note)
        setattr(fn, CONTRACT_ATTR, c)
        CONTRACT_REGISTRY[key] = c
        return fn
    return deco
