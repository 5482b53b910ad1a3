"""Dense SwiGLU MLP (MoE is a later slice)."""
from __future__ import annotations

import torch.nn.functional as F


def mlp_forward(p, cfg, x):
    h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    return h @ p["wd"]
