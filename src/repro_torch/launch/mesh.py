"""Meshes (counterpart of ``repro.launch.mesh``).

``make_local_mesh`` builds a ``torch.distributed`` DeviceMesh with axes
('data', 'model') over the running process group — the mesh that
``models/moe.DistCtx`` carries and whose axis groups the distributed code
paths reduce over.  With no process group yet it starts a world of one
(NCCL on the card, gloo on the CPU) on this process, so a single card
runs the distributed paths.  A multi-process run starts its group first
(``torch.distributed.init_process_group`` with its own address, world
size and rank: nothing on the machine announces a cluster).

``make_production_mesh`` is the reference's production mesh, (16, 16)
('data', 'model') or (2, 16, 16) ('pod', 'data', 'model'), as an
ABSTRACT mesh — axis names and sizes only.  No process here holds 256 or
512 ranks; ``launch/dryrun.py`` sizes the plan on it, and
``parallel/sharding.py`` accepts it wherever it takes a mesh.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, Tuple

import torch.distributed as tdist

from repro_torch.core.types import resolve_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh that no process group backs."""
    axis_names: Tuple[str, ...]
    axis_shape: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_shape:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def mesh_shape_for(world: int, model: int = 1) -> Tuple[int, int]:
    """(data, model) for ``world`` ranks: the model axis as asked (at most
    the world), the data axis what is left."""
    model = max(1, min(model, world))
    if world % model:
        raise ValueError(f"model axis {model} does not divide {world} ranks")
    return world // model, model


def init_world_of_one(device_type: str) -> None:
    """A process group of one rank on this process, rendezvous through a
    file store in a fresh temporary directory (no network port)."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    tdist.init_process_group(backend, store=tdist.FileStore(path, 1),
                             rank=0, world_size=1)


def make_local_mesh(model: int = 1, device_type=None):
    """A ('data', 'model') DeviceMesh over the running process group (a
    world of one started here if there is none).  ``device_type``: 'cuda'
    unless the caller names another ('cpu' for gloo); like every entry
    point of the port it raises rather than fall back to the CPU."""
    device_type = resolve_device(device_type).type
    if not tdist.is_initialized():
        init_world_of_one(device_type)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type,
                            mesh_shape_for(tdist.get_world_size(), model),
                            mesh_dim_names=("data", "model"))
