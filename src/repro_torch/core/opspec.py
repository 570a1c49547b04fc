"""Declarative delegation schemas — the typed layer over the channel.

The torch counterpart of ``repro.core.opspec``: ``Field`` / ``OpSpec`` /
``TrustSchema`` declare a delegated object, and ``Trust`` grows typed op
handles (``trust.op.get(keys)``, ``trust.op.put.then(keys, values)``) that
validate every argument against the spec at CALL time — wrong dtype kind,
wrong trailing shape, missing or unknown fields raise ``SchemaError``
naming the op and the field, before anything is queued.

Dtypes are torch dtypes; a value whose dtype KIND matches the field
(integer/bool -> integer, floating -> floating) is coerced with ``.to``,
as the JAX package coerces with ``astype``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

Pytree = Any


class SchemaError(ValueError):
    """A payload/response value does not match its declared Field.

    Raised at schema build time (inconsistent declarations) or at
    submit/handle-call time (bad argument) — always BEFORE any channel
    round runs, naming the op and field with expected vs got."""


def dtype_name(dt: torch.dtype) -> str:
    """A torch dtype's numpy name ("int32", "float32", "bfloat16")."""
    return str(dt).replace("torch.", "")


def _dtype_kind(dt: torch.dtype) -> str:
    if dt == torch.bool or not (dt.is_floating_point or dt.is_complex):
        return "integer"
    if dt.is_floating_point:
        return "floating"
    return "complex"


@dataclass(frozen=True)
class Field:
    """One named row column: ``row_shape`` is the per-row trailing shape
    (``()`` for scalars), ``dtype`` the torch dtype.  A kind mismatch or a
    trailing-shape mismatch raises ``SchemaError``."""
    name: str
    row_shape: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "row_shape",
                           tuple(int(d) for d in self.row_shape))
        if not isinstance(self.dtype, torch.dtype):
            raise SchemaError(
                f"field {self.name!r}: dtype must be a torch.dtype, got "
                f"{self.dtype!r}")

    def like(self) -> torch.Tensor:
        """One-row zeros template (the resp_like leaf shape)."""
        return torch.zeros((1,) + self.row_shape, dtype=self.dtype)

    def bind(self, value, op: str, device=None) -> torch.Tensor:
        """Validate + coerce one batch of rows for this field.  The
        leading dim is the batch; everything else must match the spec."""
        x = torch.as_tensor(value, device=device)
        if x.dim() != 1 + len(self.row_shape) \
                or tuple(x.shape[1:]) != self.row_shape:
            raise SchemaError(
                f"op {op!r}: payload field {self.name!r} expects row shape "
                f"{list(self.row_shape)} (a (R,"
                f"{', '.join(map(str, self.row_shape))}) batch), got array "
                f"of shape {list(x.shape)}")
        if x.dtype != self.dtype:
            if _dtype_kind(x.dtype) != _dtype_kind(self.dtype):
                raise SchemaError(
                    f"op {op!r}: payload field {self.name!r} expects dtype "
                    f"{self.dtype} (kind {_dtype_kind(self.dtype)}), got "
                    f"{x.dtype} (kind {_dtype_kind(x.dtype)}); cast "
                    f"explicitly if the conversion is intended")
            x = x.to(self.dtype)
        return x


@dataclass(frozen=True)
class ListField(Field):
    """A bounded list-valued column: one row carries up to ``max_len``
    elements, padded with ``pad`` — the declaration for ops that answer
    with variable-length collections (a sequence's page chain).  On the
    wire it is exactly a ``Field`` with row shape ``(max_len,)`` (int32
    words for the pack kernel); the subclass carries the padding contract
    so facades and tests can recover the logical lists.

        pages = ListField("pages", max_len=8, dtype=torch.int32)
        pages.counts(resp["pages"])   # per-row logical lengths
        pages.trim(resp["pages"][i])  # one row without the padding
    """
    max_len: int = 1
    pad: int = -1

    def __post_init__(self):
        if not self.row_shape:
            object.__setattr__(self, "row_shape", (int(self.max_len),))
        super().__post_init__()
        if self.row_shape != (self.max_len,):
            raise SchemaError(
                f"list field {self.name!r}: row_shape {list(self.row_shape)} "
                f"conflicts with max_len={self.max_len}; declare max_len "
                f"only (row_shape derives as (max_len,))")

    def counts(self, rows) -> torch.Tensor:
        """Logical length of each row's list: elements != ``pad``.  Valid
        because serves pack lists left-aligned (pad only as a suffix)."""
        return (torch.as_tensor(rows) != self.pad).sum(-1)

    def trim(self, row):
        """One row's list without the padding (host-side, numpy)."""
        import numpy as np
        r = np.asarray(row.cpu() if isinstance(row, torch.Tensor) else row)
        return r[r != self.pad]


@dataclass(frozen=True)
class Combine:
    """Client-side request-combining declaration for one op: the
    archetype ("dedupe", "sum" or "last"), the payload field that keys a
    segment, the "sum" field and the response field its prior rebuilds.
    ``entrust(combine="ref")`` runs the combine pass over the ops that
    declare one (``channel.RequestCombiner``)."""
    kind: str                 # "dedupe" | "sum" | "last"
    key: str = "key"
    field: str = "value"
    resp: str = "value"

    KINDS = ("dedupe", "sum", "last")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise SchemaError(
                f"Combine kind {self.kind!r} is not one of {self.KINDS}")


@dataclass(frozen=True, eq=False)
class OpSpec:
    """Declarative spec of one delegated operation (see
    ``repro.core.opspec.OpSpec``).  ``serve`` is the masked reference
    implementation ``(state, rows, valid, client) -> (state, resp_rows)``
    over STACKED trustee tensors; ``fused``/``group_key``/``kernel_lane``
    pass through to the compiled ``DelegatedOp``.  Identity-hashed."""
    name: str
    payload: Tuple[Field, ...] = ()
    response: Tuple[Field, ...] = ()
    writes: Optional[Tuple[str, ...]] = None
    serve: Optional[Callable] = None
    group_key: Optional[Callable] = None
    kernel_lane: Optional[str] = None
    fused: Any = None
    combine: Optional[Combine] = None

    RESERVED = ("where", "then", "capacity")

    def __post_init__(self):
        object.__setattr__(self, "payload", tuple(self.payload))
        object.__setattr__(self, "response", tuple(self.response))
        reserved = [f.name for f in self.payload if f.name in self.RESERVED]
        if reserved:
            raise SchemaError(
                f"op {self.name!r}: payload field name(s) {reserved} are "
                f"reserved for handle keywords {list(self.RESERVED)}; "
                f"rename the field(s)")
        if self.writes is not None:
            object.__setattr__(self, "writes", tuple(self.writes))
            resp_names = {f.name for f in self.response}
            unknown = [w for w in self.writes if w not in resp_names]
            if unknown:
                raise SchemaError(
                    f"op {self.name!r}: writes names {unknown} not among "
                    f"its response fields {sorted(resp_names)}")
        if self.combine is not None:
            c = self.combine
            if isinstance(c, str):
                c = Combine(c)
                object.__setattr__(self, "combine", c)
            pay = {f.name for f in self.payload}
            if c.key not in pay:
                raise SchemaError(
                    f"op {self.name!r}: combine key {c.key!r} is not a "
                    f"payload field (fields: {sorted(pay)})")
            if c.kind == "sum":
                if c.field not in pay:
                    raise SchemaError(
                        f"op {self.name!r}: combine sum field {c.field!r} "
                        f"is not a payload field (fields: {sorted(pay)})")
                resp_names = {f.name for f in self.response}
                if c.resp not in resp_names:
                    raise SchemaError(
                        f"op {self.name!r}: combine resp field {c.resp!r} "
                        f"is not a response field "
                        f"(fields: {sorted(resp_names)})")

    @property
    def payload_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.payload)

    def bind(self, args: Sequence, kwargs: Dict[str, Any],
             device=None) -> Dict[str, torch.Tensor]:
        """Bind positional/keyword arguments to payload fields (positional
        follow declaration order), validating each.  Raises
        ``SchemaError`` before anything touches a queue."""
        fields = {f.name: f for f in self.payload}
        if len(args) > len(self.payload):
            raise SchemaError(
                f"op {self.name!r} takes {len(self.payload)} payload "
                f"argument(s) {list(fields)}, got {len(args)} positional")
        bound: Dict[str, Any] = {}
        for f, a in zip(self.payload, args):
            bound[f.name] = a
        for k, v in kwargs.items():
            if k not in fields:
                if k in self.RESERVED:
                    raise SchemaError(
                        f"op {self.name!r}: {k!r} is a handle keyword, not "
                        f"a payload field" + (
                            " — use handle.then(..., then=cb) for the "
                            "async callback" if k == "then" else ""))
                raise SchemaError(
                    f"op {self.name!r} has no payload field {k!r} "
                    f"(fields: {list(fields)})")
            if k in bound:
                raise SchemaError(
                    f"op {self.name!r}: payload field {k!r} given both "
                    f"positionally and by keyword")
            bound[k] = v
        missing = [n for n in fields if n not in bound]
        if missing:
            raise SchemaError(
                f"op {self.name!r}: missing payload field(s) {missing} "
                f"(expected {list(fields)})")
        out = {n: fields[n].bind(v, self.name, device)
               for n, v in bound.items()}
        rows = {int(v.shape[0]) for v in out.values()}
        if len(rows) > 1:
            raise SchemaError(
                f"op {self.name!r}: payload fields disagree on the batch "
                f"size: {{{', '.join(f'{n}: {int(v.shape[0])}' for n, v in out.items())}}}")
        return out


def _check_consistent(kind: str, per_op) -> Dict[str, Field]:
    """Fields sharing a name across ops must agree on row shape and dtype."""
    seen: Dict[str, Tuple[str, Field]] = {}
    for op_name, f in per_op:
        if f.name not in seen:
            seen[f.name] = (op_name, f)
            continue
        first_op, first = seen[f.name]
        if (first.row_shape, first.dtype) != (f.row_shape, f.dtype):
            raise SchemaError(
                f"{kind} field {f.name!r} is declared as {first.dtype}"
                f"{list(first.row_shape)} by op {first_op!r} but as "
                f"{f.dtype}{list(f.row_shape)} by op {op_name!r}; ops of "
                f"one schema must agree on shared {kind} fields")
    return {n: f for n, (_op, f) in seen.items()}


class TrustSchema:
    """A delegated object's contract: op table + state schema + routing
    rule.  ``route(payload, n_trustees) -> dst`` computes each row's
    destination trustee from the validated payload.  ``reshard(host_state,
    old_t, new_t) -> host_state`` re-lays a logical owner-major state (the
    JAX layout, numpy ``(T * rows, ...)`` leaves) out for another trustee
    count: it lets failover move the state onto a shrunk mesh."""

    def __init__(self, name: str, ops: Sequence[OpSpec],
                 state: Optional[Dict[str, Field]] = None,
                 route: Optional[Callable] = None,
                 reshard: Optional[Callable] = None):
        self.name = name
        self.ops = tuple(ops)
        self.reshard = reshard
        if not self.ops:
            raise SchemaError(f"schema {name!r} declares no ops")
        names = [o.name for o in self.ops]
        if len(set(names)) != len(names):
            raise SchemaError(f"schema {name!r}: duplicate op names {names}")
        self.state = dict(state) if state else None
        self.route = route
        self.op_index = {o.name: i for i, o in enumerate(self.ops)}
        self.payload_fields = _check_consistent(
            "payload", [(o.name, f) for o in self.ops for f in o.payload])
        self.response_fields = _check_consistent(
            "response", [(o.name, f) for o in self.ops for f in o.response])
        for o in self.ops:
            if o.response and \
                    {f.name for f in o.response} != set(self.response_fields):
                raise SchemaError(
                    f"schema {name!r}: op {o.name!r} responds with "
                    f"{sorted(f.name for f in o.response)} but the schema's "
                    f"response struct is {sorted(self.response_fields)}; "
                    f"every responding op must produce the same struct "
                    f"(declare the full struct and use writes= for the "
                    f"subset actually written)")
        self._delegated = None

    def fingerprint(self) -> str:
        """Identity for checkpoint manifests: a hash of the contract a
        restore must match (op names, payload / response field layouts,
        writes, the state schema), not of the trustee count.  Dtypes are
        named as numpy names them, so the port and the JAX package give
        one contract the same hex string."""
        import hashlib
        parts = [self.name]
        for o in self.ops:
            parts.append(f"op:{o.name}")
            for kind, fields in (("p", o.payload), ("r", o.response)):
                for f in fields:
                    parts.append(f"{kind}:{f.name}:{dtype_name(f.dtype)}:"
                                 f"{f.row_shape}")
            parts.append(f"w:{sorted(o.writes or ())}")
        if self.state is not None:
            for n in sorted(self.state):
                f = self.state[n]
                parts.append(f"s:{n}:{dtype_name(f.dtype)}:{f.row_shape}")
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]

    def resp_like(self) -> Dict[str, torch.Tensor]:
        """One one-row zeros leaf per response field, in declaration
        order."""
        for o in self.ops:
            if o.response:
                return {f.name: f.like() for f in o.response}
        return {}

    def delegated_ops(self):
        """The runtime op table (one ``DelegatedOp`` per OpSpec), cached."""
        if self._delegated is None:
            from .channel import DelegatedOp
            self._delegated = tuple(
                DelegatedOp(o.name, o.serve, group_key=o.group_key,
                            kernel_lane=o.kernel_lane, resp_fields=o.writes,
                            fused=o.fused, spec=o, combine=o.combine)
                for o in self.ops)
        return self._delegated

    def validate_state(self, state: Pytree) -> None:
        """Check a stacked state dict against the state schema: leaf names,
        trailing shapes (after the (T, rows) leading dims) and dtypes."""
        if self.state is None:
            return
        if not isinstance(state, dict) or set(state) != set(self.state):
            got = sorted(state) if isinstance(state, dict) else type(state)
            raise SchemaError(
                f"schema {self.name!r} state expects leaves "
                f"{sorted(self.state)}, got {got}")
        for n, f in self.state.items():
            leaf = state[n]
            if tuple(leaf.shape[2:]) != f.row_shape or leaf.dtype != f.dtype:
                raise SchemaError(
                    f"schema {self.name!r} state leaf {n!r} expects "
                    f"{f.dtype}[T, R, {', '.join(map(str, f.row_shape))}], "
                    f"got {leaf.dtype}{list(leaf.shape)}")

    def bind_payload(self, op: str, payload: Dict[str, Any],
                     device=None) -> Dict[str, torch.Tensor]:
        """Validate a payload DICT for ``op`` (the stringly shim path).  An
        unknown op name raises ``KeyError``; payload problems raise
        ``SchemaError``."""
        if op not in self.op_index:
            raise KeyError(
                f"schema {self.name!r} has no op {op!r} "
                f"(ops: {[o.name for o in self.ops]})")
        return self.ops[self.op_index[op]].bind((), dict(payload), device)

    def dst_for(self, payload: Dict[str, torch.Tensor], n_trustees: int,
                where=None) -> torch.Tensor:
        """Destination trustee per row via the schema router; ``where``
        (bool mask) deactivates rows (dst = -1) without touching keys."""
        if self.route is None:
            raise SchemaError(
                f"schema {self.name!r} declares no route= rule; pass dst "
                f"explicitly via Trust.apply/submit")
        dst = self.route(payload, n_trustees).to(torch.int32)
        if where is not None:
            w = torch.as_tensor(where, device=dst.device).to(torch.bool)
            if tuple(w.shape) != tuple(dst.shape):
                raise SchemaError(
                    f"schema {self.name!r}: where= mask of shape "
                    f"{list(w.shape)} does not match the batch "
                    f"{list(dst.shape)}")
            dst = torch.where(w, dst, torch.full_like(dst, -1))
        return dst

    def __repr__(self):
        return (f"TrustSchema({self.name!r}, ops={[o.name for o in self.ops]}, "
                f"route={'yes' if self.route else 'no'})")


class OpHandle:
    """Callable handle for one op of a schema'd Trust.

    ``handle(*rows, where=mask)`` validates, routes and runs a solo round,
    returning the response dict; ``handle.then(*rows, where=, then=)``
    queues the batch for the next ``flush()`` / ``session.step()`` and
    returns a ``TrustFuture``."""

    __slots__ = ("_trust", "_spec", "_op_id")

    def __init__(self, trust, spec: OpSpec, op_id: int):
        self._trust = trust
        self._spec = spec
        self._op_id = op_id

    @property
    def spec(self) -> OpSpec:
        return self._spec

    def _bind(self, args, kwargs, where):
        payload = self._spec.bind(args, kwargs, self._trust.device)
        dst = self._trust.schema.dst_for(payload, self._trust.n_trustees,
                                         where)
        return dst, payload

    def __call__(self, *args, where=None, capacity=None, **kwargs) -> Pytree:
        dst, payload = self._bind(args, kwargs, where)
        return self._trust._apply_validated(self._op_id, dst, payload,
                                            capacity)

    def then(self, *args, where=None, then=None, **kwargs):
        dst, payload = self._bind(args, kwargs, where)
        return self._trust._submit_validated(self._op_id, dst, payload, then)

    def __repr__(self):
        return (f"<op {self._trust.name}.{self._spec.name}"
                f"({', '.join(self._spec.payload_names)})>")


class OpNamespace:
    """``trust.op`` — one generated ``OpHandle`` attribute per OpSpec."""

    def __init__(self, trust, schema: TrustSchema):
        self._handles = {
            spec.name: OpHandle(trust, spec, i)
            for i, spec in enumerate(schema.ops)}
        for name, h in self._handles.items():
            if name.isidentifier() and not hasattr(type(self), name):
                setattr(self, name, h)

    def __getitem__(self, name: str) -> OpHandle:
        return self._handles[name]

    def __getattr__(self, name: str) -> OpHandle:
        try:
            return self.__dict__["_handles"][name]
        except KeyError:
            raise AttributeError(
                f"no op {name!r} (ops: {sorted(self.__dict__['_handles'])})"
            ) from None

    def __iter__(self):
        return iter(self._handles.values())

    def __repr__(self):
        return f"<ops {sorted(self._handles)}>"
