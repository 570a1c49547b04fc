"""The Trust<T> delegation channel over stacked shards.

The torch counterpart of ``repro.core.channel``.  The JAX functions are
per-shard code inside ``shard_map``; here every function takes all shards
at once, stacked along a leading dimension:

  * client side  — ``dst`` (D, R), payload leaves (D, R, ...): client
                   shard d's slice of the fused request batch;
  * trustee side — received rows (T, N, ...), the table (T, K, W).

In shared mode every shard is both a client and a trustee (D == T), the
request all_to_all is a (src, dst) block transpose of the slot buffers,
and the response transpose is the same transpose back.  Serve order is
the JAX channel's: each trustee serves all clients' primary blocks in
client order, then all second_round blocks, then — with the local
shortcut — its own self-addressed rows, appended after the channel rows.
Within one (client, trustee) block rows keep their issue order (FIFO).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from ..kernels import ops as kops
from ..kernels.delegation_serve import row_block
from ..kernels.ref import take_rows

Pytree = Any

# ---------------------------------------------------------------------------
# Implementation-event side channel: a provider that cannot run the impl
# the config asked for (the f32-only serve kernel on a non-f32 table)
# reports it here; ``delegate`` collects the events around the serve and
# the engine surfaces them as ``last_stats()[...]["impl_fallback"]``.
# ---------------------------------------------------------------------------

_impl_event_sinks: List[List[str]] = []


def report_impl_event(event: str) -> None:
    """Record an implementation fallback (no-op outside any collector)."""
    for sink in _impl_event_sinks:
        sink.append(event)


@contextlib.contextmanager
def collect_impl_events():
    """Collect ``report_impl_event`` calls made while the body runs."""
    events: List[str] = []
    _impl_event_sinks.append(events)
    try:
        yield events
    finally:
        _impl_event_sinks.remove(events)


@dataclass(frozen=True)
class ChannelConfig:
    """Channel knobs (see ``repro.core.channel.ChannelConfig``).

    ``pack_impl`` / ``serve_impl`` take "ref" (plain PyTorch) or "kernel"
    (the CUDA kernels; their plain versions on CPU tensors), and
    ``serve_impl`` also "masked" (the per-op reference serve).  The JAX
    Pallas tile-size fields have no counterpart: the CUDA kernels pick
    their own launch shapes."""
    axis: Any = "model"
    capacity: int = 0
    overflow: str = "drop"          # "drop" | "second_round"
    overflow_capacity: int = 0
    local_shortcut: bool = False
    pack_impl: str = "kernel"
    mode: str = "shared"
    n_clients: int = 0
    max_rounds: int = 1
    serve_impl: str = "kernel"
    elide_resp: Tuple[str, ...] = ()
    strict_impl: bool = False
    combine_impl: str = "off"

    def second_capacity(self) -> int:
        """Rows per pair in the second_round block (0 when there is none)."""
        if self.overflow == "second_round" and self.overflow_capacity > 0:
            return self.overflow_capacity
        return 0

    def total_capacity(self) -> int:
        if self.overflow == "second_round":
            return self.capacity + self.overflow_capacity
        return self.capacity

    def fuse_sig(self) -> Tuple:
        """Channel-compatibility signature: the fields two Trusts must agree
        on to share one multiplexed round (the JAX field list, less the
        tile sizes)."""
        return (self.axis, self.overflow, self.local_shortcut,
                self.pack_impl, self.serve_impl, self.mode, self.n_clients,
                self.max_rounds, self.capacity, self.overflow_capacity,
                self.strict_impl, self.combine_impl)


class Packed(NamedTuple):
    """Client-side packed request slots, every client shard stacked."""
    slots: Pytree                 # leaves (D, T*C, ...) — primary block
    counts: torch.Tensor          # (D, T) int32 — count header per pair
    slots2: Optional[Pytree]      # second_round leaves (D, T*C2, ...)
    counts2: Optional[torch.Tensor]
    request_slot: torch.Tensor    # (D, R) int32 in [0, T*C + T*C2) or -1
    dropped: torch.Tensor         # (D, R) bool — active but not sent


class Received(NamedTuple):
    """Trustee-side received requests, every trustee shard stacked."""
    rows: Pytree                  # leaves (T, N, ...)
    valid: torch.Tensor           # (T, N) bool
    client: torch.Tensor          # (T, N) int32 — originating client
    grouping: Any = None          # Optional[Grouping]


class TileMeta(NamedTuple):
    """Per-row-tile segment metadata of the JAX tiled serve kernels (the
    cross-tile ADD carry).  The CUDA serve does not need it — its
    segmented scan spans blocks — but it is kept for parity."""
    block_rows: int
    n_tiles: int
    first_sid: torch.Tensor       # (..., n_tiles) int32, -1 all-padding
    last_sid: torch.Tensor
    cont: torch.Tensor            # (..., n_tiles) bool


class Grouping(NamedTuple):
    """ONE stable sort of the received rows by (op, group key) per round,
    per trustee shard (leading dims are kept).  Every array except
    ``order``/``inv`` is in SORTED coordinates; rows of one (op, key)
    segment are contiguous and keep request order, so last-writer-wins is
    the segment's last row and fetch-and-add priors are segment-exclusive
    prefix sums."""
    order: torch.Tensor           # sorted position -> original row
    inv: torch.Tensor             # original row -> sorted position
    gid_sorted: torch.Tensor      # (op, key) group id of sorted row i
    seg_start: torch.Tensor       # first sorted position of the segment
    seg_end: torch.Tensor         # one past its last position
    rank: torch.Tensor            # position - seg_start
    seg_end_row: torch.Tensor     # seg_end in request coordinates

    def tile_meta(self, block_rows: int = 256) -> TileMeta:
        """Per-tile segment boundaries for a tiled consumer; padding rows
        carry sid -1 (the JAX kernel wrapper's padding)."""
        n = int(self.seg_start.shape[-1])
        br = row_block(n, block_rows)
        n_tiles = -(-n // br)
        sid = self.seg_start.to(torch.int32)
        lead = tuple(sid.shape[:-1])
        pad = n_tiles * br - n
        if pad:
            sid = torch.cat([sid, torch.full(lead + (pad,), -1,
                                             dtype=torch.int32,
                                             device=sid.device)], -1)
        tiles = sid.reshape(lead + (n_tiles, br))
        first, last = tiles[..., 0], tiles[..., -1]
        cont = torch.cat([torch.zeros(lead + (1,), dtype=torch.bool,
                                      device=sid.device),
                          first[..., 1:] == last[..., :-1]], -1)
        return TileMeta(br, n_tiles, first, last, cont)


def _flip_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, [-1]), dim=-1).values, [-1])


def make_grouping(gid: torch.Tensor) -> Grouping:
    """The shared grouping from a per-row group id (sentinel = max), over
    the last dimension: one stable sort, then segment boundaries from
    running max/min scans over the sorted ids."""
    n = gid.shape[-1]
    dev = gid.device
    pos = torch.arange(n, dtype=torch.int32, device=dev).expand(gid.shape)
    gid_sorted, order = torch.sort(gid, dim=-1, stable=True)
    inv = torch.empty(gid.shape, dtype=torch.int32, device=dev) \
        .scatter_(-1, order, pos)
    order = order.to(torch.int32)
    lead = tuple(gid.shape[:-1])
    changed = gid_sorted[..., 1:] != gid_sorted[..., :-1]
    one = torch.ones(lead + (1,), dtype=torch.bool, device=dev)
    is_start = torch.cat([one, changed], -1)
    is_end = torch.cat([changed, one], -1)
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=-1).values
    seg_end = _flip_cummin(torch.where(is_end, pos + 1, n))
    return Grouping(order, inv, gid_sorted, seg_start, seg_end,
                    pos - seg_start, torch.gather(seg_end, -1, inv.long()))


# ---------------------------------------------------------------------------
# pack
# ---------------------------------------------------------------------------

def _group_positions(dst: torch.Tensor, n_trustees: int):
    """Stable grouping of each client's requests by destination: (order,
    key_sorted, pos_sorted, group_sizes), all (D, ...)."""
    d, r = dst.shape
    dev = dst.device
    key = torch.where(dst < 0, torch.full_like(dst, n_trustees), dst) \
        .to(torch.int32)
    key_sorted, order = torch.sort(key, dim=-1, stable=True)
    grid = torch.arange(n_trustees + 1, dtype=torch.int32, device=dev) \
        .expand(d, n_trustees + 1).contiguous()
    starts = torch.searchsorted(key_sorted, grid).to(torch.int32)
    pos_sorted = torch.arange(r, dtype=torch.int32, device=dev) \
        - starts.gather(-1, key_sorted.long())
    group_sizes = starts[:, 1:] - starts[:, :-1]
    return order, key_sorted, pos_sorted, group_sizes


def _scatter_rows(payload: Pytree, order: torch.Tensor,
                  row_ids: torch.Tensor, valid: torch.Tensor,
                  n_rows: int) -> Pytree:
    """Scatter payload rows (in sorted order) into a slot buffer; invalid
    rows land on a dump row that is sliced off."""
    d = order.shape[0]
    idx = torch.where(valid, row_ids, torch.full_like(row_ids, n_rows)).long()
    b = torch.arange(d, device=order.device)[:, None]
    out = {}
    for name, leaf in payload.items():
        buf = torch.zeros((d, n_rows + 1) + tuple(leaf.shape[2:]),
                          dtype=leaf.dtype, device=leaf.device)
        buf[b, idx] = take_rows(leaf, order)
        out[name] = buf[:, :n_rows]
    return out


_WORD_DTYPES = (torch.float32, torch.int32)
_WIDENED = (torch.int16, torch.int8, torch.uint8, torch.bool)
_HALF = (torch.float16, torch.bfloat16)


def _encode_words(payload: Pytree, d: int, r: int):
    """Flatten a payload dict into one (D, R, W) int32 word matrix for the
    pack kernel: f32/int32 columns are reinterpreted, narrower ints and
    bools widened, f16/bf16 upcast to f32 first — all exact."""
    cols, decs, col = [], [], 0
    for name in sorted(payload):
        leaf = payload[name]
        mat = leaf.reshape(d, r, -1)
        dt = leaf.dtype
        if dt in _WORD_DTYPES:
            mat = mat.view(torch.int32)
        elif dt in _HALF:
            mat = mat.to(torch.float32).view(torch.int32)
        elif dt in _WIDENED:
            mat = mat.to(torch.int32)
        else:
            raise TypeError(
                f"pack: payload field {name!r} of dtype {dt} cannot ride "
                f"32-bit words exactly")
        cols.append(mat)
        decs.append((name, col, mat.shape[-1], dt, tuple(leaf.shape[2:])))
        col += mat.shape[-1]
    return torch.cat(cols, -1).contiguous(), decs


def _decode_words(words: torch.Tensor, decs) -> Pytree:
    out = {}
    lead = tuple(words.shape[:2])
    for name, c0, w, dt, trail in decs:
        block = words[..., c0:c0 + w]
        if dt == torch.int32:
            v = block
        elif dt == torch.float32:
            v = block.view(torch.float32)
        elif dt in _HALF:
            v = block.view(torch.float32).to(dt)
        elif dt == torch.bool:
            v = block != 0
        else:
            v = block.to(dt)
        out[name] = v.reshape(lead + trail)
    return out


def _pack_with_kernel(dst: torch.Tensor, payload: Pytree, n_trustees: int,
                      cfg: ChannelConfig):
    """``pack`` through the pack kernel: one launch places the primary and
    the second_round block for every client shard."""
    d, r = dst.shape
    c1, c2 = cfg.capacity, cfg.second_capacity()
    words, decs = _encode_words(payload, d, r)
    s1, s2, counts1, counts2, request_slot, totals = kops.delegation_pack(
        dst.to(torch.int32).contiguous(), words, n_trustees, c1, c2)
    slots2 = _decode_words(s2, decs) if c2 else None
    dropped = (request_slot < 0) & (dst >= 0)
    return Packed(_decode_words(s1, decs), counts1, slots2,
                  counts2 if c2 else None, request_slot, dropped), totals


def pack(dst: torch.Tensor, payload: Pytree, n_trustees: int,
         cfg: ChannelConfig):
    """Client side: bin each client's requests into per-trustee slots.

    dst: (D, R) int32 trustee id per request, -1 = inactive.  Returns
    (Packed, group_sizes (D, T)) — group_sizes is pre-capacity demand.
    ``cfg.pack_impl``: "ref" sorts in plain PyTorch, "kernel" runs the
    pack kernel; both place every row identically."""
    if cfg.capacity < 1:
        raise ValueError(f"channel capacity must be positive, got "
                         f"{cfg.capacity}")
    if cfg.pack_impl == "kernel":
        return _pack_with_kernel(dst, payload, n_trustees, cfg)
    if cfg.pack_impl != "ref":
        raise ValueError(f"unknown pack_impl {cfg.pack_impl!r} "
                         f"(want 'ref' or 'kernel')")
    t, c1 = n_trustees, cfg.capacity
    order, key_sorted, pos_sorted, group_sizes = _group_positions(dst, t)
    active_sorted = key_sorted < t
    in1 = active_sorted & (pos_sorted < c1)
    rows1 = key_sorted * c1 + torch.clamp(pos_sorted, max=c1 - 1)
    slots1 = _scatter_rows(payload, order, rows1, in1, t * c1)
    counts1 = torch.clamp(group_sizes, max=c1)
    minus1 = torch.full_like(rows1, -1)
    slot_of_sorted = torch.where(in1, rows1, minus1)
    sent_sorted = in1
    slots2 = counts2 = None
    c2 = cfg.second_capacity()
    if c2:
        pos2 = pos_sorted - c1
        in2 = active_sorted & (pos2 >= 0) & (pos2 < c2)
        rows2 = key_sorted * c2 + torch.clamp(pos2, 0, c2 - 1)
        slots2 = _scatter_rows(payload, order, rows2, in2, t * c2)
        counts2 = torch.clamp(group_sizes - c1, 0, c2)
        slot_of_sorted = torch.where(in2, t * c1 + rows2, slot_of_sorted)
        sent_sorted = in1 | in2
    request_slot = torch.empty_like(slot_of_sorted).scatter_(
        -1, order, slot_of_sorted)
    sent = torch.empty_like(sent_sorted).scatter_(-1, order, sent_sorted)
    dropped = ~sent & (dst >= 0)
    return Packed(slots1, counts1, slots2, counts2, request_slot,
                  dropped), group_sizes


# ---------------------------------------------------------------------------
# transmit / respond / unpack
# ---------------------------------------------------------------------------

def _transpose_blocks(leaf: torch.Tensor, c: int) -> torch.Tensor:
    """(A, B*c, ...) -> (B, A*c, ...): block (a, b) of c rows moves from
    shard a's slot b to shard b's slot a — the all_to_all."""
    a = leaf.shape[0]
    trail = tuple(leaf.shape[2:])
    b = leaf.shape[1] // c
    return leaf.reshape((a, b, c) + trail).transpose(0, 1) \
        .reshape((b, a * c) + trail)


def transmit(packed: Packed, n_trustees: int, cfg: ChannelConfig) -> Received:
    """Move request slots to their trustees: the delegation message."""
    d = packed.counts.shape[0]
    dev = packed.counts.device

    def send_block(slots, counts, c):
        rows = {k: _transpose_blocks(v, c) for k, v in slots.items()}
        cnt = counts.transpose(0, 1)                      # (T, D)
        valid = (torch.arange(c, device=dev)[None, None, :]
                 < cnt[..., None]).reshape(n_trustees, d * c)
        client = torch.arange(d, dtype=torch.int32, device=dev) \
            .repeat_interleave(c).expand(n_trustees, d * c)
        return rows, valid, client

    rows, valid, client = send_block(packed.slots, packed.counts,
                                     cfg.capacity)
    if packed.slots2 is not None:
        rows2, valid2, client2 = send_block(packed.slots2, packed.counts2,
                                            cfg.overflow_capacity)
        rows = {k: torch.cat([rows[k], rows2[k]], 1) for k in rows}
        valid = torch.cat([valid, valid2], 1)
        client = torch.cat([client, client2], 1)
    return Received(rows, valid, client)


def respond(responses: Pytree, n_trustees: int, cfg: ChannelConfig) -> Pytree:
    """Move response rows back to their clients' slots (the transpose
    back).  Leaves (T, n_chan, ...) -> (D, T*C [+ T*C2], ...)."""
    c1, c2 = cfg.capacity, cfg.second_capacity()
    out = {}
    for k, leaf in responses.items():
        n1 = (leaf.shape[1] // (c1 + c2)) * c1
        back = _transpose_blocks(leaf[:, :n1], c1)
        if c2:
            back = torch.cat([back, _transpose_blocks(leaf[:, n1:], c2)], 1)
        out[k] = back
    return out


def unpack(responses_at_client: Pytree, request_slot: torch.Tensor) -> Pytree:
    """Client side: responses back into request order; rows that were not
    sent (slot -1) come back as zeros."""
    safe = torch.clamp(request_slot, min=0)
    sent = request_slot >= 0
    out = {}
    for k, leaf in responses_at_client.items():
        rows = take_rows(leaf, safe)
        m = sent.reshape(tuple(sent.shape) + (1,) * (rows.dim() - 2))
        out[k] = torch.where(m, rows, torch.zeros_like(rows))
    return out


# ---------------------------------------------------------------------------
# the synchronous round: pack -> transmit -> serve -> respond -> unpack
# ---------------------------------------------------------------------------

ServeFn = Callable[[Pytree, Received], Tuple[Pytree, Pytree]]


class ChannelInfo(NamedTuple):
    group_sizes: torch.Tensor   # (D, T) pre-capacity demand per client
    dropped: torch.Tensor       # (D, R) bool — active rows not sent
    n_rows: int                 # channel rows per trustee per round
    impl_fallback: int = 0      # implementation fallbacks in the serve


def resp_elision_bytes(resp_like: Pytree, cfg: ChannelConfig,
                       n_rows: int) -> int:
    """Response-transpose bytes per shard saved by eliding the fields no
    op of the round writes (one row of a leaf is its trailing size times
    its itemsize)."""
    if not isinstance(resp_like, dict) or n_rows <= 0:
        return 0
    saved = 0
    for name, leaf in resp_like.items():
        if name in cfg.elide_resp:
            trailing = 1
            for s in leaf.shape[1:]:
                trailing *= int(s)
            saved += n_rows * trailing * leaf.element_size()
    return saved


def _merge_local(responses: Pytree, local_resp: Pytree,
                 local_mask: torch.Tensor) -> Pytree:
    out = {}
    for k, chan in responses.items():
        m = local_mask.reshape(tuple(local_mask.shape)
                               + (1,) * (chan.dim() - 2))
        out[k] = torch.where(m, local_resp[k], chan)
    return out


def _respond_unpack(resp_rows: Pytree, request_slot: torch.Tensor,
                    n_trustees: int, cfg: ChannelConfig,
                    local_resp: Optional[Pytree] = None,
                    local_mask: Optional[torch.Tensor] = None) -> Pytree:
    """respond -> unpack -> merge-local; fields in ``cfg.elide_resp`` skip
    the transpose and come back as zeros (a PUT-only round moves no
    response at all)."""
    kept = {k: v for k, v in resp_rows.items() if k not in cfg.elide_resp}
    out = {}
    if kept:
        out = unpack(respond(kept, n_trustees, cfg), request_slot)
        if local_resp is not None:
            out = _merge_local(out, {k: local_resp[k] for k in kept},
                               local_mask)
    shape = tuple(request_slot.shape)
    for k, v in resp_rows.items():
        if k not in kept:
            out[k] = torch.zeros(shape + tuple(v.shape[2:]), dtype=v.dtype,
                                 device=v.device)
    return {k: out[k] for k in resp_rows}


def _split_local(dst: torch.Tensor, payload: Pytree):
    """Local-trustee shortcut: requests addressed to their own shard skip
    the channel and are appended to that trustee's serve batch, after the
    channel rows (shared mode: client shard d is trustee d)."""
    d, r = dst.shape
    my_id = torch.arange(d, dtype=torch.int32, device=dst.device)[:, None]
    local_mask = dst == my_id
    remote_dst = torch.where(local_mask, torch.full_like(dst, -1), dst)
    local_recv = Received(rows=payload, valid=local_mask,
                          client=my_id.expand(d, r))
    return remote_dst, local_recv, local_mask


def _concat_received(a: Received, b: Received) -> Received:
    return Received(
        rows={k: torch.cat([a.rows[k], b.rows[k]], 1) for k in a.rows},
        valid=torch.cat([a.valid, b.valid], 1),
        client=torch.cat([a.client, b.client], 1))


def delegate(state: Pytree, dst: torch.Tensor, payload: Pytree,
             serve_fn: ServeFn, n_trustees: int, cfg: ChannelConfig):
    """Synchronous delegation: pack -> transmit -> serve -> respond ->
    unpack over every shard at once.  ``dst`` (D, R) holds trustee ids.
    Returns (new_state, responses (D, R, ...), ChannelInfo)."""
    if cfg.mode != "shared":
        raise NotImplementedError(
            "dedicated trustee mode is not ported yet (ROADMAP.md queue A: "
            "dedicated mode)")
    d, r = dst.shape
    local_recv = local_mask = None
    if cfg.local_shortcut:
        dst, local_recv, local_mask = _split_local(dst, payload)
        if n_trustees == 1:
            with collect_impl_events() as events:
                new_state, local_resp = serve_fn(state, local_recv)
            info = ChannelInfo(
                torch.zeros((d, 1), dtype=torch.int32, device=dst.device),
                torch.zeros((d, r), dtype=torch.bool, device=dst.device), 0,
                impl_fallback=len(events))
            return new_state, local_resp, info

    packed, group_sizes = pack(dst, payload, n_trustees, cfg)
    received = transmit(packed, n_trustees, cfg)
    n_chan = received.valid.shape[1]
    if local_recv is not None:
        received = _concat_received(received, local_recv)
    with collect_impl_events() as events:
        new_state, resp_rows = serve_fn(state, received)
    local_resp = None
    if local_recv is not None:
        local_resp = {k: v[:, n_chan:] for k, v in resp_rows.items()}
        resp_rows = {k: v[:, :n_chan] for k, v in resp_rows.items()}
    responses = _respond_unpack(resp_rows, packed.request_slot, n_trustees,
                                cfg, local_resp, local_mask)
    info = ChannelInfo(group_sizes, packed.dropped,
                       n_trustees * cfg.total_capacity(),
                       impl_fallback=len(events))
    return new_state, responses, info


# ---------------------------------------------------------------------------
# op table — the "vtable" of delegated closures
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DelegatedOp:
    """A registered, vectorized operation a trustee can apply.

    ``apply(state, rows, valid, client) -> (new_state, response_rows)``
    works on stacked trustee tensors and is a no-op on rows where
    ``valid`` is False (the masked reference serve).  ``group_key(state,
    rows) -> (keys, n_groups)`` joins the shared grouping pass, ``fused``
    points the ops of one object at one provider that applies the whole
    op-mix, ``kernel_lane`` names the op's lane in that provider, and
    ``resp_fields`` the response fields the op writes (None = all)."""
    name: str
    apply: Callable
    group_key: Optional[Callable] = None
    kernel_lane: Optional[str] = None
    resp_fields: Optional[Tuple[str, ...]] = None
    fused: Any = None
    spec: Any = None
    combine: Any = None


def check_response_structs(named_resps) -> None:
    """Every op of one serve table must answer with the same response
    struct; raise naming both ops otherwise."""
    first = None
    for label, resp in named_resps:
        sig = tuple((k, tuple(v.shape[2:]), str(v.dtype))
                    for k, v in sorted(resp.items()))
        if first is None:
            first = (label, sig)
        elif first[1] != sig:
            raise ValueError(
                f"ops fused into one serve table must agree on the response "
                f"structure: op {first[0]!r} responds with {list(first[1])} "
                f"but op {label!r} responds with {list(sig)}; give the ops "
                f"matching responses or serve them from separate Trusts")


def _serve_grouping(ops, ids, state, received: Received) -> Optional[Grouping]:
    """The shared grouping pass: one stable sort by (op, group key) per
    trustee shard.  None when no active op declares ``group_key``."""
    grouped = [i for i in ids if ops[i].group_key is not None]
    if not grouped:
        return None
    rows, valid = received.rows, received.valid
    multi = len(ids) > 1
    op_col = rows["op"] if multi else None
    keys, spans, shared = {}, [], {}
    for i in grouped:
        fn = ops[i].group_key
        if fn not in shared:
            k, span = fn(state, rows)
            shared[fn] = (k.to(torch.int32), int(span))
        keys[i], span = shared[fn]
        spans.append(span)
    span = max(max(spans), 1)
    sentinel = len(ids) * span
    gid = torch.full(valid.shape, sentinel, dtype=torch.int32,
                     device=valid.device)
    for rank_i, i in enumerate(ids):
        m = valid & (op_col == i) if multi else valid
        key_i = torch.clamp(keys[i], 0, span - 1) if i in keys \
            else torch.zeros_like(gid)
        gid = torch.where(m, rank_i * span + key_i, gid)
    return make_grouping(gid)


def _masked_pass(ops, ids, state, received: Received):
    rows = received.rows
    out_resp, first = None, None
    for i in ids:
        m = received.valid & (rows["op"] == i) if len(ids) > 1 \
            else received.valid
        state, resp = ops[i].apply(state, rows, m, received.client)
        if out_resp is None:
            first = (ops[i].name, resp)
            out_resp = {k: torch.zeros_like(v) for k, v in resp.items()}
        else:
            check_response_structs([first, (ops[i].name, resp)])
        out_resp = {
            k: torch.where(m.reshape(tuple(m.shape)
                                     + (1,) * (v.dim() - 2)), v, out_resp[k])
            for k, v in resp.items()}
    return state, out_resp


def serve_optable(ops: Tuple[DelegatedOp, ...],
                  active_ids: Optional[Tuple[int, ...]] = None,
                  serve_impl: str = "kernel",
                  cfg: Optional[ChannelConfig] = None) -> ServeFn:
    """Multi-op serve: rows carry an "op" column when more than one op is
    active.  ``serve_impl``:

      * "ref"    — one shared grouping pass per round; when every active
                   op shares a fused provider (the KV table's), the whole
                   op-mix applies in one pass of plain PyTorch segment
                   primitives;
      * "kernel" — the same grouping, the mix applied by the CUDA serve
                   kernels;
      * "masked" — one masked full-buffer pass per op (the differential
                   reference).

    All three are bit-identical on integer-exact payloads."""
    ids = tuple(range(len(ops))) if active_ids is None else tuple(active_ids)
    if serve_impl == "masked":
        return lambda state, received: _masked_pass(ops, ids, state,
                                                    received)
    if serve_impl not in ("ref", "kernel"):
        raise ValueError(f"unknown serve_impl {serve_impl!r} "
                         f"(want ref|kernel|masked)")
    fused = ops[ids[0]].fused
    if fused is None or any(ops[i].fused is not fused for i in ids):
        fused = None

    def serve(state, received: Received):
        grouping = _serve_grouping(ops, ids, state, received)
        received = received._replace(grouping=grouping)
        if fused is not None and grouping is not None:
            return fused.serve(ops, ids, state, received, serve_impl, cfg)
        return _masked_pass(ops, ids, state, received)
    return serve
