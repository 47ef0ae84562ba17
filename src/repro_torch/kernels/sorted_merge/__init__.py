from .ops import merge_positions, overlay_scatter, rank_count

__all__ = ["merge_positions", "overlay_scatter", "rank_count"]
