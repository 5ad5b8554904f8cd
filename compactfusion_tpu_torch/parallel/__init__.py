"""parallel (PyTorch port of compactfusion_tpu/parallel).  The JAX
package's ``MeshSpec`` and ``AXIS_SEQ`` (a sharding spec over the ring and
Ulysses axes) have no counterpart: the port's ``Mesh`` is process groups."""

from compactfusion_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_CFG,
    AXIS_DP,
    AXIS_PP,
    AXIS_RING,
    AXIS_TP,
    AXIS_ULYSSES,
    make_mesh,
)
