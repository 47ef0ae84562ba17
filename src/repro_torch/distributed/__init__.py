"""repro_torch.distributed — D4M-semiring telemetry.

:class:`~repro_torch.distributed.metrics.MetricsStore` keeps metrics as
``(step, name) → value`` triples of a host ``Assoc`` and merges them by
⊕; the query server logs into one per worker thread.  Gradient
compression and fault tolerance (``repro.distributed``'s other modules)
come with the training half of the LLM scaffold.
"""
from .metrics import MetricsStore

__all__ = ["MetricsStore"]
