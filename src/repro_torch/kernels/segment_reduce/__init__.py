from .ops import aggregate_runs, segment_scan

__all__ = ["aggregate_runs", "segment_scan"]
