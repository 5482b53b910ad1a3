"""Coral's two-stage optimiser: hardware and model descriptors, profile
tables, placement, the Serving Template library (offline) and the
allocation ILP over it (online), with the paper's baselines.

Library-sized arrays (profile rows, the placement cache's group rows, the
frontier's codes and the library's columns) are tensors on an explicit
device, ``cuda`` unless the caller passes ``device="cpu"``. The searches
that are sequential by nature run on the host, each at a named crossing
(``repro_torch.solver.milp.to_host``).
"""
