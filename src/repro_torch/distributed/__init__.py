"""repro_torch.distributed — fault tolerance, straggler mitigation,
gradient compression, and D4M-semiring telemetry.

:class:`~repro_torch.distributed.metrics.MetricsStore` keeps metrics as
``(step, name) → value`` triples of a host ``Assoc`` and merges them by
⊕; the query server logs into one per worker thread and the train launcher
into one per run.  :func:`run_resilient` is the train launcher's step loop
(checkpoint restore and deterministic data replay after a failure);
:func:`compress_tree` / :func:`decompress_tree` are int8 error-feedback
gradient compression on the optimizer's q8 layout.
"""
from .compression import compress_tree, decompress_tree
from .fault_tolerance import (FaultToleranceConfig, HeartbeatMonitor,
                              RestartPolicy, StragglerMitigator, run_resilient)
from .metrics import MetricsStore

__all__ = ["HeartbeatMonitor", "RestartPolicy", "StragglerMitigator",
           "FaultToleranceConfig", "run_resilient", "MetricsStore",
           "compress_tree", "decompress_tree"]
