"""Execution across ranks: landmark-sharded Schur solves and data-parallel
sums over ``torch.distributed`` (port of ``nllstpu/parallel``)."""

from .mesh import DATA_AXIS, make_mesh, parallelize  # noqa: F401
from .schur_shard import optimize_sharded, parallelize_schur  # noqa: F401
