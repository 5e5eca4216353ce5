"""Crossbar numerics of the port: INT8 quantization and 2-bit ReRAM cell
arithmetic (PyTorch counterparts of `repro.xbar.quant` and
`repro.xbar.cells`)."""
