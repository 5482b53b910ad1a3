"""The card the port runs on, as the dry-run's roofline and memory check
read it: the H100 row of the JAX package's hardware table (its paper's
Table 1), copied here so that the port imports nothing of that package."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceType:
    name: str
    mem_gb: float            # HBM per device, GB (1e9 bytes)
    bw_tbps: float           # HBM bandwidth, TB/s
    tflops: float            # dense bf16 TFLOP/s per device
    intra_node_gbps: float   # per-device NVLink bandwidth inside a node, GB/s

    @property
    def mem_bytes(self) -> float:
        return self.mem_gb * 1e9


H100 = DeviceType("H100", 80, 3.35, 989, 450)
