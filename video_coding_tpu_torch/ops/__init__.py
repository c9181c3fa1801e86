"""Block datapath: integer Chen transforms and the K2/K3 kernels."""
