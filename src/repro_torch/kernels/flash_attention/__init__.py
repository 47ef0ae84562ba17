from .ops import (FlashAttentionFn, flash_attention, flash_attention_bwd_cuda,
                  flash_attention_cuda)

__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_bwd_cuda",
           "flash_attention_cuda"]
