"""The stacked-shard mesh and the ambient session/mesh context.

JAX runs the delegation channel inside ``shard_map`` over a device mesh.
The port keeps every shard of that mesh on ONE device, stacked along a
leading tensor dimension: a ``StackedMesh(shape=(2, 4))`` stands for the
2x4 JAX mesh, and every per-shard array of the JAX program becomes one
``(8, ...)`` tensor.  The channel's collectives follow from that layout:
``all_to_all`` is a (src, dst) block transpose, ``psum`` a sum over the
leading dimension, and ``axis_index`` an ``arange``.  A trustee group
over a sub-axis (``"model"`` of a (2, 4) mesh) stacks its shards in
``group_order``: the block transpose and the sums stay inside each
replica (the shards that share the other axes' coordinates).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for the card where there is none raises instead of falling back.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

_state = threading.local()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.  Raises
    ``RuntimeError`` when CUDA is asked for (explicitly or by default) and
    no CUDA device is present — nothing silently falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch paths")
    return dev


def to_device_async(a, device: torch.device) -> torch.Tensor:
    """A host int32 array on ``device`` without a host sync: on a card,
    through pinned memory and a non-blocking copy on the current stream
    (a pageable copy would wait for the stream's earlier work)."""
    x = torch.as_tensor(np.ascontiguousarray(a, np.int32))
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


class StackedMesh:
    """A JAX-style named mesh whose shards are stacked on one device.

    ``shape`` gives the axis sizes (row-major over ``axis_names``, like
    ``jax.sharding.Mesh``); ``size`` is the number of stacked shards, and
    shard ``i`` is the flat row-major index ``i`` — the same slot a leading
    dimension sharded with ``P(axis_names)`` lands on in JAX."""

    def __init__(self, shape: Sequence[int] = (1, 1),
                 axis_names: Sequence[str] = ("data", "model"),
                 device=None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(
                f"mesh shape {shape} and axis names {axis_names} differ in "
                f"length")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
        self.dims = shape
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.device = resolve_device(device)
        size = 1
        for s in shape:
            size *= s
        self.size = size

    def _key(self):
        return (self.dims, self.axis_names, self.device)

    def __eq__(self, other):
        return isinstance(other, StackedMesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"StackedMesh(shape={self.dims}, axis_names="
                f"{self.axis_names}, device={str(self.device)!r})")


def survivors_mesh(old_mesh: StackedMesh, failed_shards, survivors=None,
                   plan=None) -> StackedMesh:
    """The shrunk mesh a failover re-entrusts onto (see
    ``repro.core.meshctx.survivors_mesh``): the shard slots of
    ``old_mesh`` minus the dead flat slots ``failed_shards`` (or the
    explicit slot list ``survivors``), shaped by the ``ElasticPlan``'s
    rung (default: the delegation ladder, 1-D trustee rings shrinking one
    shard at a time) with the OLD axis names — leading axes 1, the last
    axis the surviving ring — on the same device.  A stacked shard has no
    device identity, so survivors are slots and only their count shapes
    the mesh; the state itself comes from the logical snapshot."""
    failed = {int(s) for s in failed_shards}
    surv = (list(survivors) if survivors is not None else
            [i for i in range(old_mesh.size) if i not in failed])
    if not surv:
        raise RuntimeError("survivors_mesh: no surviving shards")
    if plan is None:
        from ..runtime.fault_tolerance import delegation_elastic_plan
        plan = delegation_elastic_plan(old_mesh.size)
    shape = plan.choose(len(surv))
    n = shape[0] * shape[1]
    dims = (1,) * (len(old_mesh.axis_names) - 1) + (n,)
    return StackedMesh(dims, old_mesh.axis_names, device=old_mesh.device)


def group_order(mesh: StackedMesh, axes) -> Tuple[np.ndarray, int, int]:
    """The stacked shards of ``mesh`` in the layout of a trustee group over
    ``axes``: ``(order, n_group, n_replicas)``, where slot ``j`` of the
    layout is replica ``j // n_group``'s group member ``j % n_group`` and
    ``order[j]`` its stacked shard.  The group axes move last (in the
    order ``axes`` gives them: a group index is row-major over them, as
    JAX's flat ``axis_index``), the other axes first in mesh order (a
    replica index is row-major over them).  A ``"model"`` group of a
    ``(data, model)`` mesh keeps the mesh order: shard ``i`` is member
    ``i % M`` of replica ``i // M``; a ``"data"`` group takes member
    ``i // M`` of replica ``i % M``."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = mesh.axis_names
    unknown = [a for a in axes if a not in names]
    if unknown or len(set(axes)) != len(axes):
        raise ValueError(f"group axes {axes} are not distinct axes of "
                         f"{names}")
    grp = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in grp]
    order = np.arange(mesh.size).reshape(mesh.dims).transpose(rest + grp) \
        .reshape(-1)
    n_group = 1
    for i in grp:
        n_group *= mesh.dims[i]
    return order, n_group, mesh.size // n_group


def group_coords(mesh: StackedMesh, axes) -> Tuple[np.ndarray, np.ndarray]:
    """Each stacked shard's (group index, replica index) in a trustee
    group over ``axes`` (see ``group_order``), two ``(mesh.size,)``
    arrays."""
    order, n_group, _ = group_order(mesh, axes)
    slot = np.empty_like(order)
    slot[order] = np.arange(order.size)
    return slot % n_group, slot // n_group


def current_mesh() -> StackedMesh:
    """The ambient mesh (a ``(1, 1)`` mesh on the default device when none
    was installed)."""
    m = getattr(_state, "mesh", None)
    if m is None:
        m = StackedMesh((1, 1))
        _state.mesh = m
    return m


def set_mesh(mesh: StackedMesh) -> None:
    _state.mesh = mesh


@contextlib.contextmanager
def use_mesh(mesh: StackedMesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def set_batch_axes(axes) -> None:
    """Override which mesh axes shard the batch ("default": the mesh's
    ``pod`` / ``data`` axes); a cell whose batch does not split over the
    data size sets ``()``, and the batch is then replicated (each data row
    runs the whole batch)."""
    _state.batch_axes = axes


def batch_axes():
    return getattr(_state, "batch_axes", "default")


def set_context(mesh: StackedMesh, axes="default") -> None:
    """Install ``mesh`` and the batch axes together (JAX's ``set_context``,
    which ``launch.steps.build_cell`` calls)."""
    set_mesh(mesh)
    set_batch_axes(axes)


@contextlib.contextmanager
def kept_context():
    """Restore the ambient mesh and batch axes on exit (an entry point
    installs its own through ``launch.steps.build_cell``)."""
    prev = (getattr(_state, "mesh", None), batch_axes())
    try:
        yield
    finally:
        _state.mesh, _state.batch_axes = prev


def axis_size(axis: str) -> int:
    """The ambient mesh's size along ``axis`` (1 when it has no such
    axis)."""
    return int(current_mesh().shape.get(axis, 1))


def data_axes() -> Tuple[str, ...]:
    """The ambient mesh's batch axes present (``pod``, ``data``)."""
    return tuple(a for a in current_mesh().axis_names
                 if a in ("pod", "data"))


def constrain(x, *spec):
    """JAX's ``with_sharding_constraint`` against the current mesh: a
    layout hint with no value of its own, so on stacked shards, where
    every shard lives in one tensor, the identity (as ``sp_residual``
    is)."""
    return x


def set_delegation_mode(mode: str = "shared", n_dedicated: int = 0) -> None:
    """Session-wide default trustee mode (the paper's shared and dedicated
    runtimes), read by ``trust.local_trustees``; the serve driver sets it
    from its ``--delegation-mode`` flag."""
    if mode not in ("shared", "dedicated"):
        raise ValueError(f"unknown delegation mode {mode!r}")
    _state.delegation_mode = (mode, n_dedicated)


def delegation_mode() -> Tuple[str, int]:
    return getattr(_state, "delegation_mode", ("shared", 0))


def current_session():
    """The ambient ``TrustSession`` (``core.engine.DelegationEngine``),
    created lazily per thread.  Every ``entrust`` registers its Trust here
    unless given a session."""
    s = getattr(_state, "session", None)
    if s is None:
        from .engine import DelegationEngine
        s = DelegationEngine()
        _state.session = s
    return s


def set_session(session) -> None:
    """Install ``session`` as the ambient TrustSession for this thread."""
    _state.session = session


@contextlib.contextmanager
def use_session(session=None):
    """Scope an (optionally fresh) TrustSession: trusts entrusted inside the
    block register with it; the previous session is restored on exit."""
    if session is None:
        from .engine import DelegationEngine
        session = DelegationEngine()
    prev = getattr(_state, "session", None)
    _state.session = session
    try:
        yield session
    finally:
        _state.session = prev

