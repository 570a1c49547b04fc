"""Trust — the user-facing handle to entrusted state (paper §3, §4).

The torch counterpart of ``repro.core.trust``.  ``TrusteeGroup.entrust``
places a dict of STACKED state tensors (leading dimension: the trustee
shard) under the care of the trustees of a ``StackedMesh``; the state is
then only reachable through the delegation channel, through the typed op
handles a ``TrustSchema`` generates:

    group = TrusteeGroup(mesh, axis=("data", "model"))
    trust = group.entrust({"table": table}, schema=kv_schema)
    vals  = trust.op.get(keys)                 # sync apply()
    fut   = trust.op.put.then(keys, values)    # apply_then()
    session.step()                             # flush pending batches

Execution lives in the session's ``DelegationEngine`` (engine.py), which
fuses the pending batches of channel-compatible trusts into one round.
The port carries both trustee modes over the whole mesh (shared: every
shard serves; dedicated: the last ``n_dedicated`` shards serve the
others), shared groups over a sub-axis (``"model"`` of a (2, 4) mesh:
4 trustees, the state replicated over ``"data"``), the defer drain
(``overflow="defer"``, ``max_rounds``), request combining
(``combine="ref"``) and failover (``install_trustee_state`` /
``rebind``, driven by ``TrustSession.re_entrust``).

A sub-axis group keeps one copy of the state per replica, as JAX's
``P(axis)`` layout does, stacked replica-major (``meshctx.group_order``):
``(R * T, rows, ...)``.  Every round mutates each replica with its own
replica's requests, so replicas can diverge (JAX leaves their coherence
to the caller); ``trustee_state()``, ``dump``, checkpoints and snapshots
read replica 0, the one JAX's read-back of the state shows.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .channel import ChannelConfig, DelegatedOp
from .compiled import CaptureError
from .meshctx import StackedMesh
from .opspec import OpNamespace, TrustSchema

Pytree = Any


def _axes_tuple(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _check_blocks(name: str, blocks) -> None:
    """``serve_blocks`` / ``pack_blocks``: None or "auto" take the
    kernels' own launch plans; a fixed tile pair is refused."""
    if blocks is None or blocks == "auto":
        return
    raise NotImplementedError(
        f"{name}={blocks!r}: a fixed (rows, keys|slots) pair is a Pallas "
        f"tile of the JAX kernels, which the CUDA kernels have no "
        f"counterpart of — their launch shapes come from their own plans "
        f"(delegation_pack.launch_plan, delegation_serve.gather_plan / "
        f"segmented_add_plan, paged_attention.split_plan, "
        f"selective_scan.scan_plan); pass None or 'auto'")


@dataclass
class TrusteeGroup:
    """The trustees of ``mesh`` along ``axis``.

    * ``mode="shared"``: every stacked shard is both a client and a
      trustee.
    * ``mode="dedicated"``: the LAST ``n_dedicated`` shards are reserved
      trustees serving the leading ``n_clients`` client shards; entrusted
      state lives only on the trustee shards (the client shards hold a
      zero region) and requests originate only on client shards.  ``axis``
      must cover the whole mesh.

    A shared group over a sub-axis has ``n_replicas`` = mesh size / axis
    size copies of its state (one per coordinate of the other axes), each
    served by its own replica's shards."""
    mesh: StackedMesh
    axis: Any = "model"
    mode: str = "shared"
    n_dedicated: int = 0

    def __post_init__(self):
        if self.mode not in ("shared", "dedicated"):
            raise ValueError(f"unknown trustee mode {self.mode!r}")
        if self.mode == "dedicated":
            if self.axes != tuple(self.mesh.axis_names):
                raise ValueError(
                    "dedicated mode partitions the whole mesh: axis must be "
                    f"{tuple(self.mesh.axis_names)}, got {self.axes}")
            if not 0 < self.n_dedicated < self.axis_size:
                raise ValueError(
                    f"n_dedicated must be in (0, {self.axis_size}), "
                    f"got {self.n_dedicated}")
        unknown = [a for a in self.axes if a not in self.mesh.shape]
        if unknown:
            raise ValueError(f"axis {unknown} not in mesh axes "
                             f"{self.mesh.axis_names}")

    @property
    def axes(self) -> Tuple[str, ...]:
        return _axes_tuple(self.axis)

    @property
    def axis_size(self) -> int:
        n = 1
        for a in self.axes:
            n *= int(self.mesh.shape[a])
        return n

    @property
    def n_trustees(self) -> int:
        if self.mode == "dedicated":
            return self.n_dedicated
        return self.axis_size

    @property
    def n_clients(self) -> int:
        """Clients a trustee serves (the group's size in shared mode)."""
        if self.mode == "dedicated":
            return self.axis_size - self.n_dedicated
        return self.axis_size

    @property
    def n_origins(self) -> int:
        """Stacked shards that originate requests: every shard of the
        mesh in shared mode (each replica's own), the leading
        ``n_clients`` in dedicated mode."""
        if self.mode == "dedicated":
            return self.n_clients
        return self.mesh.size

    @property
    def n_replicas(self) -> int:
        """Copies of the state: one per coordinate of the axes the group
        does not span (1 for a group over the whole mesh, and in
        dedicated mode, which spans it)."""
        return self.mesh.size // self.axis_size

    def shard_order(self) -> Optional[np.ndarray]:
        """The stacked shards in the group's layout (replica-major,
        ``meshctx.group_order``), or None when that is the mesh order."""
        from .meshctx import group_order
        order, _, _ = group_order(self.mesh, self.axes)
        if np.array_equal(order, np.arange(order.size)):
            return None
        return order

    def physical_state(self, stacked: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The group's physical layout of a stacked logical state (T,
        rows, ...): in dedicated mode behind a zero client region, on a
        sub-axis one copy per replica, (R * T, rows, ...)."""
        if self.mode == "dedicated":
            return pad_client_region(stacked, self.n_clients)
        r = self.n_replicas
        if r == 1:
            return stacked
        return {k: v.repeat((r,) + (1,) * (v.dim() - 1))
                for k, v in stacked.items()}

    def entrust(self, state: Dict[str, torch.Tensor],
                ops: Optional[Sequence[DelegatedOp]] = None,
                resp_like: Optional[Pytree] = None,
                capacity: Optional[int] = None,
                overflow: str = "second_round", overflow_capacity: int = 0,
                local_shortcut: bool = True, max_rounds: int = 1,
                pack_impl: str = "kernel", serve_impl: str = "kernel",
                name: Optional[str] = None, plan_capacity: bool = False,
                session=None, schema: Optional[TrustSchema] = None,
                strict_impl: bool = False, serve_blocks: Any = None,
                pack_blocks: Any = None,
                combine: str = "off",
                schema_factory: Optional[Callable[[int], TrustSchema]] = None
                ) -> "Trust":
        """Move ``state`` (a dict of (T, rows, ...) tensors) under trustee
        ownership and return the Trust handle; see
        ``repro.core.trust.TrusteeGroup.entrust`` for every knob.  The
        state is copied onto the mesh's device, so the caller's tensors
        are never updated in place.  In dedicated mode each leaf is placed
        behind a zero client region, ``(n_clients + T, rows, ...)``, and
        the local shortcut is off (a client is never its own trustee); a
        sub-axis group copies it into every replica, ``(R * T, rows,
        ...)``.  ``serve_blocks`` / ``pack_blocks`` take None or "auto"
        (the kernels' own launch plans); a fixed tile pair raises.
        ``overflow="defer"`` re-sends the rows past ``capacity`` in up to
        ``max_rounds - 1`` retry rounds; ``combine="ref"`` sends one wire
        row per (destination, op, key) segment of the ops that declare a
        combine archetype.  ``schema_factory(n_trustees) -> TrustSchema``
        (given without ``schema=``) builds the schema for this group's
        trustee count, and failover rebuilds it for the survivors'
        (``TrustSession.re_entrust``): serve closures bake T in."""
        if combine not in ("off", "ref"):
            raise ValueError(
                f"combine must be 'off' or 'ref', got {combine!r}")
        if overflow not in ("drop", "second_round", "defer"):
            raise ValueError(f"unknown overflow policy {overflow!r}")
        if max_rounds < 1:
            raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
        # "auto" (JAX: tiles from its roofline model) is the kernels' own
        # launch plans, the port's only ones
        _check_blocks("serve_blocks", serve_blocks)
        _check_blocks("pack_blocks", pack_blocks)
        if pack_impl not in ("ref", "kernel"):
            raise ValueError(f"pack_impl must be 'ref' or 'kernel', got "
                             f"{pack_impl!r}")
        if serve_impl not in ("ref", "kernel", "masked"):
            raise ValueError(f"serve_impl must be 'ref', 'kernel' or "
                             f"'masked', got {serve_impl!r}")
        if schema is None and schema_factory is not None:
            schema = schema_factory(self.n_trustees)
        if schema is not None:
            if ops is not None or resp_like is not None:
                raise ValueError(
                    "entrust takes EITHER schema= (typed, derives ops and "
                    "resp_like) OR ops=/resp_like= (legacy), not both")
            schema.validate_state(state)
            ops = schema.delegated_ops()
            resp_like = schema.resp_like()
        elif ops is None or resp_like is None:
            raise ValueError(
                "entrust needs a schema= (typed path) or both ops= and "
                "resp_like= (legacy path)")
        t = self.n_trustees
        placed = {}
        for k, v in state.items():
            if v.dim() < 2 or v.shape[0] != t:
                raise ValueError(
                    f"state leaf {k!r} of shape {list(v.shape)} is not "
                    f"stacked over the {t} trustee shards (T, rows, ...)")
            placed[k] = v.to(self.mesh.device, copy=True,
                             memory_format=torch.contiguous_format)
        dedicated = self.mode == "dedicated"
        placed = self.physical_state(placed)
        if dedicated:
            local_shortcut = False
        cfg = ChannelConfig(
            axis=self.axis if len(self.axes) > 1 else self.axes[0],
            capacity=0 if not capacity else capacity, overflow=overflow,
            overflow_capacity=overflow_capacity,
            local_shortcut=local_shortcut, pack_impl=pack_impl,
            serve_impl=serve_impl, mode=self.mode,
            n_clients=self.n_clients if dedicated else 0,
            max_rounds=max_rounds, strict_impl=strict_impl,
            combine_impl=combine, n_replicas=self.n_replicas)
        return Trust(self, placed, tuple(ops), resp_like, cfg, name=name,
                     plan_capacity=plan_capacity, session=session,
                     schema=schema, schema_factory=schema_factory)


def pad_client_region(state: Dict[str, torch.Tensor],
                      n_clients: int) -> Dict[str, torch.Tensor]:
    """Dedicated mode's physical layout: each (T, rows, ...) leaf behind
    ``n_clients`` shards of zeros, (n_clients + T, rows, ...)."""
    return {k: torch.cat([torch.zeros((n_clients,) + tuple(v.shape[1:]),
                                      dtype=v.dtype, device=v.device), v])
            for k, v in state.items()}


@dataclass
class TrustFuture:
    """Host-level future for ``submit`` (apply_then analog)."""
    _result: Optional[Pytree] = None
    _then: Optional[Callable[[Pytree], None]] = None
    trust: str = ""
    op: str = ""

    def ready(self) -> bool:
        return self._result is not None

    def result(self) -> Pytree:
        if self._result is None:
            raise RuntimeError(
                f"result of op {self.op!r} on trust {self.trust!r} is not "
                f"ready: the submitted batch has not been served — flush() "
                f"the trust (or run session.step()) first")
        return self._result

    def _fulfil(self, value: Pytree) -> None:
        self._result = value
        if self._then is not None:
            self._then(value)


class Trust:
    """Reference to entrusted state.  A schema'd Trust exposes the typed
    surface as ``trust.op``; ``apply``/``submit`` remain stringly shims
    over the same machinery."""

    def __init__(self, group: TrusteeGroup, state: Pytree,
                 ops: Tuple[DelegatedOp, ...], resp_like: Pytree,
                 cfg: ChannelConfig, name: Optional[str] = None,
                 plan_capacity: bool = False, session=None,
                 schema: Optional[TrustSchema] = None,
                 schema_factory: Optional[Callable] = None):
        self.group = group
        # a new trust's token has no compiled round yet: nothing to evict
        self._state = state
        self.ops = ops
        self.op_index = {o.name: i for i, o in enumerate(ops)}
        self.resp_like = resp_like
        self.cfg = cfg
        self.schema = schema
        self.schema_factory = schema_factory
        # failover hooks: ``rebind`` fires them once the trust is on its
        # new trustee group (facades refresh their cached layout)
        self._on_rebuild: List[Callable] = []
        self.op = OpNamespace(self, schema) if schema is not None else None
        # let the engine's EMA planner size this trust's solo rounds (auto
        # capacity only)
        self.plan_capacity = plan_capacity
        self._pending: List[Tuple[int, torch.Tensor, Pytree, TrustFuture]] = []
        self._last_stats = None
        if session is None:
            from . import meshctx
            session = meshctx.current_session()
        self.session = session
        self.token = session.register(self)
        self.name = name if name else f"trust{self.token}"

    @property
    def n_trustees(self) -> int:
        return self.group.n_trustees

    @property
    def device(self) -> torch.device:
        return self.group.mesh.device

    def state(self) -> Pytree:
        """The live physical state (in dedicated mode with the zero client
        region first): the kernel serve updates these tensors in place, so
        later rounds change them.  Clone to keep a snapshot."""
        return self._state

    def set_state(self, state: Pytree) -> None:
        self._state = state
        # the session's compiled rounds of this trust hold the old
        # state's addresses
        self.session._evict((self.token,))

    def trustee_state(self) -> Pytree:
        """The logical (T, rows, ...) state, live as ``state()`` is: in
        dedicated mode the client region is stripped off, on a sub-axis
        replica 0 (the copy JAX's read-back shows)."""
        g = self.group
        if g.mode == "dedicated":
            c = g.n_clients
            return {k: v[c:] for k, v in self._state.items()}
        if g.n_replicas > 1:
            t = g.n_trustees
            return {k: v[:t] for k, v in self._state.items()}
        return self._state

    # -- resilience ----------------------------------------------------------
    def install_trustee_state(self, logical_state: Pytree) -> None:
        """Install a LOGICAL state as the entrusted state: each leaf in the
        JAX owner-major layout, ``(T * rows, ...)`` (numpy or a tensor, as
        a snapshot or a ``reshard`` rule gives it), is stacked ``(T, rows,
        ...)`` on the group's device — in dedicated mode behind a zero
        client region, on a sub-axis into every replica — and copied,
        never aliased."""
        g = self.group
        t = g.n_trustees
        placed = {}
        for k, v in logical_state.items():
            x = v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(np.array(v))     # a writable host copy
            if x.shape[0] % t:
                raise ValueError(
                    f"state leaf {k!r}: leading dim {x.shape[0]} not "
                    f"divisible by {t} trustees")
            placed[k] = x.reshape((t, -1) + tuple(x.shape[1:])).to(
                g.mesh.device, copy=True,
                memory_format=torch.contiguous_format)
        self._state = g.physical_state(placed)
        self.session._evict((self.token,))

    def rebind(self, group: TrusteeGroup,
               schema: Optional[TrustSchema] = None,
               logical_state: Optional[Pytree] = None) -> None:
        """Re-home this trust onto a new trustee group (the failover path
        of ``TrustSession.re_entrust``): swap the group and (optionally)
        the schema with its op table and handles, reset the config's
        axis, mode, client count and shortcut (none in dedicated mode) and
        the cached fuse signature and stats, install ``logical_state``
        (owner-major) and fire the ``_on_rebuild`` hooks."""
        self.group = group
        if schema is not None:
            self.schema = schema
            self.ops = tuple(schema.delegated_ops())
            self.op_index = {o.name: i for i, o in enumerate(self.ops)}
            self.resp_like = schema.resp_like()
            self.op = OpNamespace(self, schema)
        dedicated = group.mode == "dedicated"
        self.cfg = dataclasses.replace(
            self.cfg,
            axis=group.axis if len(group.axes) > 1 else group.axes[0],
            mode=group.mode,
            n_clients=group.n_clients if dedicated else 0,
            local_shortcut=False if dedicated else self.cfg.local_shortcut,
            n_replicas=group.n_replicas)
        self._mux_sig = None
        self._last_stats = None
        if logical_state is not None:
            self.install_trustee_state(logical_state)
        for cb in self._on_rebuild:
            cb(self)

    def batch_signature(self, op_ids, sizes, payloads) -> Tuple:
        """The compiled-round cache key's part for a set of queued batches
        (JAX's): a schema'd trust keys on its schema's identity (the
        schema pins every payload field), a schema-less one on each
        payload leaf's shape and dtype."""
        if self.schema is not None:
            return (self.schema, tuple(op_ids), tuple(sizes))
        from .engine import _payload_sig
        return (tuple(op_ids), tuple(sizes),
                tuple(_payload_sig(p) for p in payloads))

    def last_drain_stats(self) -> Dict[str, int]:
        """Rounds used and the residual (rows still unserved, > 0 only when
        ``overflow="defer"`` ran out of ``max_rounds``) of this trust's
        most recent round.  Reading them waits for that round's device
        work."""
        if self._last_stats is None:
            raise RuntimeError(
                f"no delegation round has executed yet for trust "
                f"{self.name!r}: apply/flush it (or run session.step()) "
                f"before reading drain stats")
        rounds, residual = self._last_stats
        return {"rounds": int(rounds), "residual": int(residual)}

    # -- core API ------------------------------------------------------------
    def _apply_validated(self, op_id: int, dst: torch.Tensor,
                         payload: Pytree,
                         capacity: Optional[int] = None) -> Pytree:
        self.flush()
        return self.session.run_solo(self, [(op_id, dst, payload)],
                                     capacity)[0]

    def _submit_validated(self, op_id: int, dst: torch.Tensor,
                          payload: Pytree,
                          then: Optional[Callable] = None) -> TrustFuture:
        fut = TrustFuture(_then=then, trust=self.name,
                          op=self.ops[op_id].name)
        self._pending.append((op_id, dst, payload, fut))
        self.session.notify(self)
        return fut

    def _shim(self, op: str, payload: Pytree) -> Tuple[int, Pytree]:
        if self.schema is not None:
            payload = self.schema.bind_payload(op, payload, self.device)
        elif op not in self.op_index:
            raise KeyError(
                f"trust {self.name!r} has no op {op!r} "
                f"(ops: {[o.name for o in self.ops]})")
        return self.op_index[op], payload

    def apply(self, op: str, dst: torch.Tensor, payload: Pytree,
              capacity: Optional[int] = None) -> Pytree:
        """Synchronous delegation (the paper's apply())."""
        op_id, payload = self._shim(op, payload)
        return self._apply_validated(op_id, dst.to(self.device), payload,
                                     capacity)

    def submit(self, op: str, dst: torch.Tensor, payload: Pytree,
               then: Optional[Callable] = None) -> TrustFuture:
        """apply_then(): queue the batch for flush() or session.step()."""
        op_id, payload = self._shim(op, payload)
        return self._submit_validated(op_id, dst.to(self.device), payload,
                                      then)

    def flush(self, capacity: Optional[int] = None) -> None:
        """Run this trust's queued batches as ONE solo channel round."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        self.session.unnotify(self)
        try:
            resps = self.session.run_solo(
                self, [(o, d, p) for (o, d, p, _) in pending], capacity)
        except CaptureError:
            # the round ran (eagerly, before its capture failed): its
            # batches are not put back
            raise
        except Exception:
            # keep the queued batches so the caller can drop the offending
            # submit and flush again
            self._pending = pending + self._pending
            self.session.notify(self)
            raise
        for (_, _, _, fut), resp in zip(pending, resps):
            fut._fulfil(resp)

    # -- execution -----------------------------------------------------------
    def _auto_capacity(self, r_total: int) -> int:
        # mean load per (client, trustee) pair with 2x headroom, min 4 rows
        # every request originates on a client shard (dedicated mode: the
        # leading n_clients; shared mode: every shard of the mesh)
        per_client = max(1, r_total // self.group.n_origins)
        mean = max(1, per_client // self.n_trustees)
        return max(4, 2 * mean)

    def _cfg_for(self, r_total: int, capacity: Optional[int]) -> ChannelConfig:
        if capacity is None:
            capacity = self.cfg.capacity
        cap = capacity if capacity > 0 else self._auto_capacity(r_total)
        over = cap if self.cfg.overflow == "second_round" else 0
        return dataclasses.replace(
            self.cfg, capacity=cap,
            overflow_capacity=self.cfg.overflow_capacity or over)

    def fuse_signature(self) -> Tuple:
        g = self.group
        return (g.mesh, g.axes, g.mode, g.n_dedicated) \
            + self.cfg.fuse_sig()


def local_trustees(axis=None, mode: Optional[str] = None,
                   n_dedicated: Optional[int] = None) -> TrusteeGroup:
    """TrusteeGroup over the ambient mesh.  With no ``axis``, ``mode`` and
    ``n_dedicated`` default to the session-wide delegation mode
    (``meshctx.set_delegation_mode``); an explicit ``axis`` asks for a
    shared group along it (default "model", as in JAX), and dedicated mode,
    which partitions the whole mesh, refuses any other axis."""
    from . import meshctx
    mesh = meshctx.current_mesh()
    d_mode, d_n = meshctx.delegation_mode()
    if mode is None:
        mode = d_mode if axis is None else "shared"
    n_dedicated = d_n if n_dedicated is None else n_dedicated
    if mode == "dedicated":
        if axis is not None and _axes_tuple(axis) != tuple(mesh.axis_names):
            raise ValueError(
                f"dedicated mode partitions the whole mesh "
                f"{tuple(mesh.axis_names)}; it cannot honor axis={axis!r}")
        return TrusteeGroup(mesh, tuple(mesh.axis_names), mode="dedicated",
                            n_dedicated=n_dedicated)
    return TrusteeGroup(mesh, "model" if axis is None else axis)
