"""repro_torch.ingest — the Dynamic D of D4M: LSM-style streaming mutation.

* :class:`~repro_torch.ingest.table.IngestTable` — a per-table **delta
  buffer** absorbing raw triple batches, **merge-on-read** snapshots
  (base ⊕ delta through the overlay merge, memoized between mutations),
  and **compaction** that folds delta into a new base, bumps the table
  version, and invalidates the planner/compile cache entries keyed on the
  retired arrays.  Host (``Assoc``) and device (``AssocTensor``) layers.
* :class:`~repro_torch.ingest.table.Compactor` — a background thread
  compacting on a depth threshold or an idle timeout.
* :mod:`~repro_torch.ingest.merge` — the overlay merge on the device:
  the ``sorted_merge`` rank-count kernel lays out the union.
"""
from .table import Compactor, IngestTable

__all__ = ["Compactor", "IngestTable"]
