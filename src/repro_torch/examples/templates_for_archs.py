"""Coral's technique applied to the architectures the port serves:
generate Serving Templates for the port's own model zoo (dense, MoE, SSM,
hybrid) from ``repro_torch.configs.registry`` and show the
phase/architecture-dependent GPU affinity the paper builds on (§2.1) —
e.g. recurrent archs keep decode throughput at long context while
full-attention archs degrade.

Prints what the JAX package's ``examples/templates_for_archs.py`` prints.

Run:  PYTHONPATH=src python -m repro_torch.examples.templates_for_archs [--device cpu]
"""
import argparse

from repro_torch.configs.registry import get_config
from repro_torch.core.hardware import US_EAST_2, make_node_configs
from repro_torch.core.modelspec import from_model_config
from repro_torch.core.templates import generate_templates
from repro_torch.traces.workloads import workload_stats

ARCHS = ["qwen2-1.5b", "glm4-9b", "granite-moe-3b-a800m", "zamba2-1.2b",
         "xlstm-350m"]


def run(device=None):
    """Templates per (arch, phase); returns {(arch, phase): templates}."""
    configs = make_node_configs(["L40S", "L4", "A10G"], sizes=(1, 2))
    wl = workload_stats("burstgpt")
    by_name = {c.name: c for c in configs}
    out = {}
    print(f"{'arch':22s} {'phase':8s} {'templates':>9s} "
          f"{'best tok/s/$':>12s}  best combo")
    for arch in ARCHS:
        sm = from_model_config(get_config(arch), prefill_slo_ms=1200,
                               decode_slo_ms=60, trace="burstgpt")
        for phase in ("prefill", "decode"):
            temps, _ = generate_templates(sm, phase, configs, wl,
                                          n_max=3, rho=10.0, device=device)
            out[(arch, phase)] = temps
            if not temps:
                print(f"{arch:22s} {phase:8s} {'0':>9s}")
                continue
            best = max(temps, key=lambda t: t.throughput
                       / t.cost(US_EAST_2, by_name))
            eff = best.throughput / best.cost(US_EAST_2, by_name)
            print(f"{arch:22s} {phase:8s} {len(temps):9d} {eff:12.0f}  "
                  f"{dict(best.counts)} S={best.placement.n_stages}")
    print("\nRecurrent archs (zamba2, xlstm) keep O(1) decode state: their "
          "decode templates are context-length-insensitive (§2.1 affinity).")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
