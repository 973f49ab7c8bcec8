"""Distribution: logical-axis sharding rules, the mesh of ranks, collectives,
and what a rank's step costs (``cost``, the dry run's counterpart of the
JAX package's HLO analysis)."""

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
