"""Quickstart: Coral's two-stage optimization, on the port.

1. Offline — generate the Serving Template Library for two models on a
   heterogeneous GPU pool (placement solve per node combination), on the
   card unless --device says otherwise.
2. Online — solve the allocation ILP against live availability/pricing.

Prints what the JAX package's ``examples/quickstart.py`` prints.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import time

from repro_torch.core.allocator import AllocProblem, Demand, allocate
from repro_torch.core.hardware import CORE_REGIONS, make_node_configs
from repro_torch.core.modelspec import PAPER_MODELS
from repro_torch.core.templates import build_library
from repro_torch.traces.workloads import workload_stats


def run(device=None):
    """Build the library and solve one allocation; returns both."""
    models = [PAPER_MODELS["phi4-14b"], PAPER_MODELS["gpt-oss-20b"]]
    configs = make_node_configs(["L40S", "L4", "A10G"], sizes=(1, 2, 4))
    wls = {m.name: workload_stats(m.trace) for m in models}

    print("=== offline: Serving Template generation (paper §4.2) ===")
    t0 = time.time()
    lib = build_library(models, configs, wls, n_max=4, rho=8.0,
                        device=device)
    print(f"{lib.size} templates in {time.time() - t0:.1f}s")
    for (m, phase), stats in lib.stats.items():
        print(f"  {m:14s} {phase:7s}: {stats['combos']:5d} combos -> "
              f"{stats['templates']:5d} templates ({stats['seconds']:.1f}s)")

    print("\n=== online: allocation ILP (paper §4.3) ===")
    avail = {(r.name, c.name): 10 for r in CORE_REGIONS for c in configs}
    demands = []
    for m in models:
        wl = wls[m.name]
        demands.append(Demand(m.name, "prefill", 5.0 * wl.avg_prompt))
        demands.append(Demand(m.name, "decode", 5.0 * wl.avg_output))
    alloc = allocate(AllocProblem(CORE_REGIONS, configs, avail, demands,
                                  lib))
    print(f"cost ${alloc.cost_per_hour:.1f}/h, {alloc.total_nodes} nodes, "
          f"solved in {alloc.solve_seconds:.2f}s "
          f"({alloc.n_vars} variables), unmet={alloc.unmet or 'none'}")
    for (region, key), n in sorted(alloc.instances.items()):
        t = alloc.templates[key]
        print(f"  {region:22s} {key[0]:13s} {key[1]:7s} x{n}  "
              f"{dict(t.counts)}  T={t.throughput:.0f} tok/s  "
              f"stages={t.placement.n_stages} "
              f"layers={t.placement.layer_counts}")
    return lib, alloc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
