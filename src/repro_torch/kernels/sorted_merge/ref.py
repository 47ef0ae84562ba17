"""Plain torch version of the rank-count kernel: two ``searchsorted``."""
from __future__ import annotations

import torch


def rank_count_ref(i: torch.Tensor, j: torch.Tensor):
    """rank[m] = #{n : j[n] < i[m]};  hit[m] = #{n : j[n] == i[m]}."""
    j = j.contiguous()
    i = i.to(j.dtype).contiguous()
    rank = torch.searchsorted(j, i, side="left", out_int32=True)
    right = torch.searchsorted(j, i, side="right", out_int32=True)
    return rank, right - rank
