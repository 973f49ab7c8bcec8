"""Distribution: logical-axis sharding rules, the mesh of ranks, collectives."""

from repro_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    PartitionSpec,
    Rules,
    activate,
    constrain,
    current_mesh,
    make_mesh,
    shardings_for,
    spec_for_axes,
)
