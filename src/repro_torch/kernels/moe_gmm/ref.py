"""Plain PyTorch version of the MoE grouped (per-expert batched) matmul and
of its two gradients: the oracles the CUDA kernel is held against, and the
path a tensor on the CPU takes."""
from __future__ import annotations

import torch


def gmm_reference(x, w):
    """x: (E, C, d) capacity-dispatched tokens; w: (E, d, f) -> (E, C, f).
    fp32 products and sums, one rounding to x's dtype at the end."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def gmm_dx_reference(g, w):
    """The VJP of ``gmm_reference`` in x: g (E, C, f) times w^T, w (E, d, f)
    -> (E, C, d) in g's dtype."""
    return torch.einsum("ecf,edf->ecd", g.float(), w.float()).to(g.dtype)


def gmm_dw_reference(x, g):
    """The VJP of ``gmm_reference`` in w: x^T, x (E, C, d), times g (E, C, f)
    -> (E, d, f) in x's dtype."""
    return torch.einsum("ecd,ecf->edf", x.float(), g.float()).to(x.dtype)
