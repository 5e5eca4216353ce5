"""PyTorch port of the ARAS serving stack (the JAX package `repro` is the
reference).  Layout mirrors `repro`: `repro_torch/nn/layers.py` is the
counterpart of `repro/nn/layers.py`, and so on.  Hand-written CUDA kernels
for Hopper live under `repro_torch/kernels/<name>/csrc/`; each has a plain
PyTorch version beside it that CPU tensors take."""
