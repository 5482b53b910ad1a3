"""The MILP substrate (HiGHS and a numpy branch-and-bound) and the
per-model price-coordinated decomposition of the allocation ILP."""
