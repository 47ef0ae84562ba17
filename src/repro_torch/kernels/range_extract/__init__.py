from .ops import range_mask

__all__ = ["range_mask"]
