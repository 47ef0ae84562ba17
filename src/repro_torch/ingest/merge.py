"""Merge-on-read: base COO ⊕ delta overlay, on the arrays' device.

The LSM read path of the device layer has three steps:

* :func:`delta_canon` — canonicalize a raw (unsorted, duplicated) delta
  buffer into sorted merged COO: one
  :func:`~repro_torch.core.coo.dedup_sorted_coo` pass, nothing else.
* :func:`_merge_read_prog` — the overlay merge.  The base is already
  canonical (sorted by (row, col) ⇔ sorted by linearized key), so after
  canonicalizing the delta the union layout comes from the ``sorted_merge``
  rank-count kernel (:func:`overlay_scatter` → ``merge_positions``, two
  ``rank_count`` launches): scatter the base, then gather-⊕-scatter the
  delta onto the shared slots, then one compaction.  O(capb + capd) work
  and memory — the base is never re-sorted and nothing is densified.
* :func:`_merge_concat_prog` — the fallback for keyspaces too large to
  linearize into int32 (``nrows·ncols ≥ 2³¹−1``): concat + one
  canonicalize, the same result in O(cap log cap).

* :func:`dist_merge` — the sharded layer's merge: each rank concatenates
  its own shard (re-ranked onto the union keyspaces when they grew) with
  the delta that ``IngestTable.insert`` routed to it, and canonicalizes
  once.  Zero collectives; ``rank_count`` is not used, as in the JAX
  package.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.contracts import contract
from repro_torch.core.assoc_tensor import coo_compact
from repro_torch.core.coo import SENT, dedup_sorted_coo
from repro_torch.kernels.sorted_merge.ops import overlay_scatter

__all__ = ["AGG_OPS", "delta_canon", "dist_merge", "merge_read"]

# Device ingest aggregates: the associative AND commutative monoids only
# (the device canonicalization is a sort, so an order-sensitive ⊕ such as
# "concat" is host-layer-only).
AGG_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}

# the linearized-key program needs every (row, col) key below the sentinel
_LINEAR_LIMIT = 2 ** 31 - 1


def _agg_op(aggregate: str):
    op = AGG_OPS.get(aggregate)
    if op is None:
        raise ValueError(
            f"device ingest aggregate must be one of {sorted(AGG_OPS)}, "
            f"got {aggregate!r} (host-layer tables accept any Assoc "
            f"aggregator)")
    return op


def _linear_keys(rows: torch.Tensor, cols: torch.Tensor,
                 ncols: int) -> torch.Tensor:
    """int32 ``row·ncols + col`` of the valid entries, SENT elsewhere.  A
    SENT row is zeroed before the product, so no unmasked value overflows
    (the caller guarantees nrows·ncols < 2³¹−1)."""
    ok = rows != SENT
    return torch.where(ok, torch.where(ok, rows, 0) * ncols + cols, SENT)


@contract(collectives=0, name="ingest.merge_read",
          note="overlay merge via the sorted_merge rank-count kernel: "
               "base is never re-sorted, output is O(capb + capd)")
def _merge_read_prog(br, bc, bv, dr, dc, dv, ncols: int, aggregate: str):
    """base ⊕ delta overlay through the rank-count kernel; returns canonical
    ``(rows, cols, vals, nnz)`` of length ``capb + capd``."""
    op = _agg_op(aggregate)
    dr, dc, dv, _ = dedup_sorted_coo(dr, dc, dv, op)
    cap = br.shape[0] + dr.shape[0]
    # canonical COO order IS linear-key order, so both sides are sorted and
    # repetition-free, as the rank-count kernel requires
    i_dst, j_dst, j_dup = overlay_scatter(_linear_keys(br, bc, ncols),
                                          _linear_keys(dr, dc, ncols))
    i_dst, j_dst = i_dst.long(), j_dst.long()
    dev = br.device
    # one spare slot past the end absorbs every sentinel (slot ``cap``)
    out_r = torch.full((cap + 1,), SENT, dtype=torch.int32, device=dev)
    out_c = torch.full((cap + 1,), SENT, dtype=torch.int32, device=dev)
    out_v = torch.zeros(cap + 1, dtype=bv.dtype, device=dev)
    out_r[i_dst], out_c[i_dst], out_v[i_dst] = br, bc, bv
    # the delta lands second: a duplicate gathers the base value from the
    # shared slot and ⊕-combines base-on-the-left (the host combine order)
    in_bounds = j_dst < cap
    cur = torch.where(in_bounds, out_v[j_dst.clamp(max=cap - 1)],
                      torch.zeros((), dtype=bv.dtype, device=dev))
    merged = torch.where(j_dup, op(cur, dv), dv)
    out_r[j_dst], out_c[j_dst], out_v[j_dst] = dr, dc, merged
    out_r, out_c, out_v = out_r[:cap], out_c[:cap], out_v[:cap]
    # zero-drop parity with from_triples: ⊕-cancelled entries unstore
    keep = (out_r != SENT) & (out_v != 0.0)
    return coo_compact(out_r, out_c, out_v, keep)


def _merge_concat_prog(br, bc, bv, dr, dc, dv, aggregate: str):
    """Fallback overlay merge (concat + one canonicalize) for keyspaces too
    large to linearize into int32 — the same result, O(cap log cap)."""
    return dedup_sorted_coo(torch.cat([br, dr]), torch.cat([bc, dc]),
                            torch.cat([bv, dv]), _agg_op(aggregate))


@contract(collectives=0, name="ingest.append",
          note="delta-buffer canonicalize: one dedup pass, no collectives, "
               "O(cap) memory")
def delta_canon(rows, cols, vals, aggregate: str):
    """Canonicalize one padded raw delta buffer → (r, c, v, nnz)."""
    return dedup_sorted_coo(rows, cols, vals, _agg_op(aggregate))


def merge_read(base, dr, dc, dv, aggregate: str, *, nrows: int, ncols: int):
    """Overlay-merge a base AssocTensor's triples with a padded raw delta;
    returns canonical (r, c, v, nnz) of length ``capb + capd``."""
    if nrows * max(ncols, 1) < _LINEAR_LIMIT:
        return _merge_read_prog(base.rows, base.cols, base.vals, dr, dc, dv,
                                max(ncols, 1), aggregate)
    return _merge_concat_prog(base.rows, base.cols, base.vals, dr, dc, dv,
                              aggregate)


@contract(collectives=0, name="ingest.dist_merge_read",
          note="shard-local overlay merge: delta is pre-routed to the "
               "owning row shard, so zero collectives")
def dist_merge(loc, dr, dc, dv, rmap, cmap, aggregate: str, rerank: bool):
    """The sharded overlay merge on this rank: its base shard ``loc``
    (re-ranked through ``rmap``/``cmap`` when ``rerank``) ⊕ the delta
    routed to it, by concat + one canonicalize.  Zero collectives: the
    delta is pre-routed to the owning row shard.  Returns canonical
    ``(rows, cols, vals, nnz)`` of length ``cap + capd``."""
    br, bc, bv = loc.rows, loc.cols, loc.vals
    if rerank:
        ok = br != SENT
        br = torch.where(ok, rmap[br.clamp(0, rmap.shape[0] - 1).long()],
                         SENT)
        bc = torch.where(ok, cmap[bc.clamp(0, cmap.shape[0] - 1).long()],
                         SENT)
    return dedup_sorted_coo(torch.cat([br, dr]), torch.cat([bc, dc]),
                            torch.cat([bv, dv]), _agg_op(aggregate))
