from .ops import semiring_matmul

__all__ = ["semiring_matmul"]
