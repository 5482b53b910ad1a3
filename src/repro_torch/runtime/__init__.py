"""The epoch runtime: estimate, re-solve, reconcile, simulate."""
