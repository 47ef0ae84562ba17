from .ops import (bsr_pairlist, bsr_pairlist_reduce, bsr_spgemm,
                  bsr_spgemm_reduce, make_block_mask)

__all__ = ["bsr_pairlist", "bsr_pairlist_reduce", "bsr_spgemm",
           "bsr_spgemm_reduce", "make_block_mask"]
