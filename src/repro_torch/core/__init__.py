"""ARAS core algorithms of the port: §V-C weight reuse and §V-B write
planning (PyTorch/numpy counterparts of `repro.core`)."""
