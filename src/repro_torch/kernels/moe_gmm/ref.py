"""Plain PyTorch version of the MoE grouped (per-expert batched) matmul:
the oracle the CUDA kernel is held against, and the path a tensor on the
CPU takes."""
from __future__ import annotations

import torch


def gmm_reference(x, w):
    """x: (E, C, d) capacity-dispatched tokens; w: (E, d, f) -> (E, C, f).
    fp32 products and sums, one rounding to x's dtype at the end."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
