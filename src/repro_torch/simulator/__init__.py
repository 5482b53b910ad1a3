"""Stage-level event simulator of the serving cluster (host-side event
loop; its observables are tensors on the run's device)."""
