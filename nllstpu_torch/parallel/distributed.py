"""Joining the ranks of one job (port of ``nllstpu/parallel/distributed.py``).

The JAX package drives every device from one process.  The port keeps
PyTorch's idiom: one process per rank, joined by a ``torch.distributed``
process group.  Every rank builds the same problem from the same seed,
calls :func:`initialize` with its rank, then :func:`global_mesh` (or
``mesh.make_mesh``), and runs the same host loop; the collectives are
``all_reduce`` alone (``mesh.Mesh.all_reduce``).

Backend and device are chosen by the caller and never switched: rank ``r``
runs on ``cuda:(r % torch.cuda.device_count())`` unless it asks for the CPU
(``make_mesh(device="cpu")``).  ``"nccl"`` takes ranks that each have a
card of their own (NCCL refuses two ranks on one device); ``"gloo"`` takes
the CPU, and ranks that share a card (it stages each ``all_reduce``
through the host).  Every collective runs under the group's ``timeout``,
so that a rank that takes another branch fails the run instead of hanging
it.  The rendezvous is the caller's: a ``tcp://localhost:<port>`` or
``file://<path>`` ``init_method``, the world size and the rank.

Run on the CPU with two processes::

    from nllstpu_torch.parallel import distributed, optimize_sharded
    distributed.initialize("gloo", "file:///tmp/store", world_size=2, rank=r)
    mesh = distributed.global_mesh(device="cpu")
    result = optimize_sharded(problem, mesh, options)
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, make_mesh, parallelize  # noqa: F401

BACKENDS = ("gloo", "nccl")


def check_backend(backend: str, world_size: int, device_count: int) -> None:
    """Raise ``ValueError`` unless ``world_size`` ranks on one host with
    ``device_count`` cards can run ``backend``: ``"nccl"`` needs a card per
    rank, since rank ``r`` runs on card ``r % device_count`` and NCCL
    refuses two ranks on one device; ``"gloo"`` runs anywhere."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and world_size > device_count:
        raise ValueError(
            f"backend 'nccl' with {world_size} ranks on {device_count} card(s): rank r "
            f"runs on card r % {device_count}, so ranks would share a card, which NCCL "
            "refuses (duplicate GPU); use 'gloo' for ranks that share a card"
        )


def initialize(backend: str = "gloo", init_method: str = None, world_size: int = None,
               rank: int = None, timeout: datetime.timedelta = datetime.timedelta(minutes=5)):
    """Join this process to the job's default process group as ``rank`` of
    ``world_size`` (``torch.distributed.init_process_group``), after
    :func:`check_backend`.  ``timeout`` bounds every collective."""
    check_backend(backend, world_size,
                  torch.cuda.device_count() if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout)


def global_mesh(device=None):
    """The mesh of every rank of the job (``mesh.make_mesh``)."""
    return make_mesh(device=device)


def local_batch_slice(n_total: int) -> slice:
    """The ``[start, stop)`` slice of ``n_total`` items that this rank owns
    (for loading only its part of the data)."""
    nproc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    per = -(-n_total // nproc)
    return slice(pid * per, min((pid + 1) * per, n_total))
