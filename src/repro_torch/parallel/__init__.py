"""Distribution substrate: mesh-aware sharding rules and collectives —
PyTorch port of `repro.parallel`."""
from repro_torch.parallel.sharding import (
    MeshCtx,
    batch_axes,
    current_mesh,
    make_spec,
    set_mesh,
    shard,
    use_mesh,
)

__all__ = [
    "MeshCtx", "batch_axes", "current_mesh", "make_spec", "set_mesh",
    "shard", "use_mesh",
]
