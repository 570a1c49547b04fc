"""Mesh construction (the torch counterpart of ``repro.launch.mesh``).

Every function returns a ``StackedMesh``: the JAX mesh's shards stacked
on one device (``device``, default ``cuda``), with JAX's shape and axis
names, so every ``PartitionSpec``-shaped rule of the JAX program (a
trustee group over ``"model"``, a batch over ``"data"``) has its axes.
"""
from __future__ import annotations

from ..configs.base import MeshConfig
from ..core.meshctx import StackedMesh


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> StackedMesh:
    """The (16, 16) ``(data, model)`` mesh, or the (2, 16, 16) ``(pod,
    data, model)`` one, stacked."""
    return make_mesh_from_config(mesh_config(multi_pod=multi_pod), device)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    if multi_pod:
        return MeshConfig((2, 16, 16), ("pod", "data", "model"))
    return MeshConfig((16, 16), ("data", "model"))


def make_mesh_from_config(cfg: MeshConfig, device=None) -> StackedMesh:
    return StackedMesh(tuple(cfg.shape), tuple(cfg.axes), device=device)


def make_local_mesh(data: int = 1, model: int = 1, device=None
                    ) -> StackedMesh:
    """A ``(data, model)`` mesh of ``data * model`` stacked shards."""
    return StackedMesh((data, model), ("data", "model"), device=device)
