"""Hardware profiles: the paper's Table 1 GPU types and the Helix pool,
node configurations (type x GPUs per node), regions and cloud pricing.

The optimiser is hardware-agnostic: every device type is a
``DeviceType(cost, mem, bw, flops, ...)`` record, so the same template
generator and allocator run over any pool of nodes. The H100 row takes
its memory, bandwidth, peak and NVLink figures from
``repro_torch.configs.hardware.H100``, the card the port runs on, so the
two tables hold one fact.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.configs import hardware as _card


@dataclass(frozen=True)
class DeviceType:
    name: str
    mem_gb: float            # HBM per device
    bw_tbps: float           # HBM bandwidth, TB/s
    tflops: float            # dense (bf16/fp16) TFLOP/s per device
    rel_cost: float          # hourly price relative to L4 (Table 1)
    intra_node_gbps: float   # per-device interconnect inside a node (NVLink)
    has_fast_interconnect: bool = True


# --- Table 1 (paper) -------------------------------------------------------
H100 = DeviceType(_card.H100.name, _card.H100.mem_gb, _card.H100.bw_tbps,
                  _card.H100.tflops, 7.6, _card.H100.intra_node_gbps)
A100 = DeviceType("A100", 80, 2.04, 312, 3.5, 300)
L40S = DeviceType("L40S", 48, 0.86, 362, 2.2, 32, has_fast_interconnect=False)
L4 = DeviceType("L4", 24, 0.30, 121, 1.0, 16, has_fast_interconnect=False)
A10G = DeviceType("A10G", 24, 0.60, 70, 1.2, 16, has_fast_interconnect=False)
# Helix §6.6 comparison pool additionally uses:
A100_40G = DeviceType("A100-40G", 40, 1.56, 312, 2.8, 300)
V100 = DeviceType("V100-16G", 16, 0.90, 112, 1.45, 150)
T4 = DeviceType("T4", 16, 0.32, 65, 0.55, 16, has_fast_interconnect=False)

DEVICE_TYPES: Dict[str, DeviceType] = {
    d.name: d for d in (H100, A100, A100_40G, L40S, L4, A10G, V100, T4)
}

# Hourly price of a 1xL4 node in USD (anchor for rel_cost).
L4_NODE_USD_PER_HOUR = 0.81


@dataclass(frozen=True)
class NodeConfig:
    """A provisionable cloud node: k devices of one type (TP/EP inside)."""
    device: DeviceType
    n_devices: int

    @property
    def name(self) -> str:
        return f"{self.n_devices}x{self.device.name}"

    @property
    def mem_gb(self) -> float:
        return self.device.mem_gb * self.n_devices

    @property
    def bw_tbps(self) -> float:
        return self.device.bw_tbps * self.n_devices

    @property
    def tflops(self) -> float:
        return self.device.tflops * self.n_devices

    def tp_efficiency(self) -> float:
        """Fraction of linear scaling retained by intra-node TP."""
        if self.n_devices == 1:
            return 1.0
        base = 0.92 if self.device.has_fast_interconnect else 0.80
        # mild degradation with TP degree
        return base ** (self.n_devices.bit_length() - 1)

    @property
    def rel_cost(self) -> float:
        # multi-GPU nodes carry a small premium (bigger host, NVSwitch)
        premium = 1.0 + 0.05 * (self.n_devices.bit_length() - 1)
        return self.device.rel_cost * self.n_devices * premium

    @property
    def usd_per_hour(self) -> float:
        return self.rel_cost * L4_NODE_USD_PER_HOUR


def make_node_configs(device_names: List[str],
                      sizes: Tuple[int, ...] = (1, 2, 4, 8)) -> List[NodeConfig]:
    return [NodeConfig(DEVICE_TYPES[d], k) for d in device_names for k in sizes]


# Paper §6.1 pools.
CORE_DEVICES = ["L40S", "L4", "A10G"]                       # 12 configs
EXT_DEVICES = CORE_DEVICES + ["H100", "A100"]               # 20 configs
CORE_CONFIGS = make_node_configs(CORE_DEVICES)
EXT_CONFIGS = make_node_configs(EXT_DEVICES)

# Inter-node (PP / data-plane) network, GB/s per node — cloud ethernet/EFA.
INTER_NODE_GBPS = 12.5          # 100 Gbit/s
INTER_NODE_LATENCY_S = 25e-6    # per hop
# Inter-region links are prohibitive for PP (paper §4.2): templates never
# span regions; only the allocator crosses regions.


@dataclass(frozen=True)
class Region:
    name: str
    # price multiplier per device type (regional price differences)
    price_mult: Dict[str, float] = field(default_factory=dict)

    def node_usd_per_hour(self, cfg: NodeConfig) -> float:
        return cfg.usd_per_hour * self.price_mult.get(cfg.device.name, 1.0)


# Paper §6.1: AWS US-East-2 + AP-Northeast-2 (core), + GCP US-Central-1 (ext).
US_EAST_2 = Region("aws-us-east-2", {})
AP_NE_2 = Region("aws-ap-northeast-2", {"L40S": 1.18, "L4": 1.12, "A10G": 1.10,
                                        "H100": 1.15, "A100": 1.20})
US_CENTRAL_1 = Region("gcp-us-central-1", {"L40S": 0.95, "L4": 1.05, "A10G": 1.30,
                                           "H100": 0.92, "A100": 1.05})
CORE_REGIONS = [US_EAST_2, AP_NE_2]
EXT_REGIONS = [US_EAST_2, AP_NE_2, US_CENTRAL_1]
