"""Hand-written Hopper kernels (sources in ``repro_torch/csrc``), each with
a plain PyTorch version that runs only for tensors on the CPU."""
