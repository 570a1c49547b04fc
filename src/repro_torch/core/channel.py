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
In dedicated mode the last T of the D shards are trustees: trustee ids
become shard slots past the ``n_clients`` client shards, rows that
originate on a trustee shard are masked off, and the transpose stays over
all D shards (client slots carry empty blocks).

A trustee group over a sub-axis of the mesh (``"model"`` of a (2, 4)
mesh: T = 4 trustees, R = 2 replicas) stacks its D = R * T shards
replica-major (``meshctx.group_order``): shard ``r * T + t`` is client
and trustee ``t`` of replica ``r``, and holds replica ``r``'s copy of
trustee ``t``'s state.  Every transpose moves blocks within a replica
(JAX's ``all_to_all`` over the group axis), the shortcut compares a
row's destination with its shard's group index, and the drain's counts
are per replica (JAX's ``psum`` over the group axis); the reported
``rounds``, ``residual`` and ``rows_combined`` are replica 0's, the
value a replicated output of JAX's ``shard_map`` reads.

A multiplexed round (``engine.py``) gives each Trust its own ``capacity``
lane inside every (client, trustee) block: ``dst`` then holds virtual
bins ``trustee * n_lanes + lane``, and with ``wire_fmt="planes"`` every
payload leaf and the validity column ride ONE int32 word matrix, so a
block moves in one transpose each way.  ``collect_transposes`` counts
them (the jaxpr ``all_to_all`` count of the JAX tests).
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from . import compiled, routing
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

# each side channel's sinks are registered with ``compiled``: a captured
# round's reports are recorded at its capture and made again on each replay
_impl_event_sinks: List[List[str]] = compiled.side_channel([])


def _drop(sinks: List[list], sink: list) -> None:
    """Remove ``sink`` itself (not an equal list) from ``sinks``."""
    sinks[:] = [s for s in sinks if s is not sink]


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
        _drop(_impl_event_sinks, events)


# ---------------------------------------------------------------------------
# Block-transpose side channel: every (src, dst) block transpose that
# transmit and respond make — the all_to_all of the JAX channel — is
# reported here, so a caller can count a round's transposes.
# ---------------------------------------------------------------------------

_transpose_sinks: List[List[str]] = compiled.side_channel([])
_transpose_byte_sinks: List[List[Tuple[str, int]]] = \
    compiled.side_channel([])


@contextlib.contextmanager
def collect_transpose_bytes():
    """Collect (what, bytes) for each block transpose made while the body
    runs: the bytes of the stacked tensor moved (read once, written once
    by the copy) — the dry run's collective term."""
    events: List[Tuple[str, int]] = []
    _transpose_byte_sinks.append(events)
    try:
        yield events
    finally:
        _drop(_transpose_byte_sinks, events)


@contextlib.contextmanager
def collect_transposes():
    """Collect one entry per block transpose made while the body runs:
    "request", "request counts" (the tree format's count header),
    "response", or "response lanes [..]" when elided lanes stay off the
    wire (the lanes that moved)."""
    events: List[str] = []
    _transpose_sinks.append(events)
    try:
        yield events
    finally:
        _drop(_transpose_sinks, events)


# ---------------------------------------------------------------------------
# Deferred launches: a multiplexed serve runs every member's pre-launch
# checks before the first kernel writes a table in place, so a round that
# raises leaves every member's state as it was.
# ---------------------------------------------------------------------------

_launch_sinks: List[List[Callable[[], None]]] = []


@contextlib.contextmanager
def deferred_launches():
    """Collect the launches ``launch_or_defer`` is handed while the body
    runs; the caller issues them, in order, once the body returns."""
    calls: List[Callable[[], None]] = []
    _launch_sinks.append(calls)
    try:
        yield calls
    finally:
        _drop(_launch_sinks, calls)


def launch_or_defer(fn: Callable[[], None]) -> None:
    """Run ``fn`` now, or queue it on the innermost ``deferred_launches``."""
    if _launch_sinks:
        _launch_sinks[-1].append(fn)
    else:
        fn()


@dataclass(frozen=True)
class ChannelConfig:
    """Channel knobs (see ``repro.core.channel.ChannelConfig``).

    ``pack_impl`` / ``serve_impl`` take "ref" (plain PyTorch) or "kernel"
    (the CUDA kernels; their plain versions on CPU tensors), and
    ``serve_impl`` also "masked" (the per-op reference serve).  The JAX
    Pallas tile-size fields have no counterpart: the CUDA kernels pick
    their own launch shapes.

    ``wire_fmt`` "tree" moves each payload leaf in its own transpose,
    "planes" moves the whole block as one int32 word matrix with the
    validity column beside it (exact for every dtype ``_encode_words``
    takes; JAX's f32 hi/lo split exists only for its MXU and has no
    counterpart).  ``n_lanes`` is the slot lanes a destination slot holds
    (the multiplexed round's per-trust lanes), and ``elide_lanes`` the
    lanes whose trust writes no response field: their rows stay off the
    response transpose ("planes" only).  ``n_replicas`` > 1 is a sub-axis
    group's: the stacked shards are that many replicas of the group,
    replica-major, and every transpose stays inside a replica."""
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
    wire_fmt: str = "tree"          # "tree" | "planes"
    n_lanes: int = 1
    elide_lanes: Tuple[int, ...] = ()
    n_replicas: int = 1             # a sub-axis group's replicas

    def n_slots(self, n_trustees: int) -> int:
        """Destination slots a shard in the block layout: one a trustee in
        shared mode; in dedicated mode every shard of the transpose, the
        trustees at slots ``n_clients + t`` and the client slots empty."""
        if self.mode == "dedicated":
            return n_trustees + self.n_clients
        return n_trustees

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
    # "planes" wire of the pack kernel: (words, words2, decs) — the slots
    # as the kernel wrote them, left undecoded (``slots`` is then None)
    wire: Any = None


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


def make_grouping(gid: torch.Tensor,
                  gid2: Optional[torch.Tensor] = None) -> Grouping:
    """The shared grouping from a per-row group id (sentinel = max), over
    the last dimension: one stable sort, then segment boundaries from
    running max/min scans over the sorted ids.  ``gid2`` adds a secondary
    key: rows group by the pair ``(gid, gid2)`` (the combine pass's
    (destination, span) x key, which one int32 could not hold), sorted by
    two stable sorts, the secondary key first."""
    n = gid.shape[-1]
    dev = gid.device
    pos = torch.arange(n, dtype=torch.int32, device=dev).expand(gid.shape)
    if gid2 is None:
        gid_sorted, order = torch.sort(gid, dim=-1, stable=True)
    else:
        _, order2 = torch.sort(gid2, dim=-1, stable=True)
        gid_sorted, by1 = torch.sort(torch.gather(gid, -1, order2), dim=-1,
                                     stable=True)
        order = torch.gather(order2, -1, by1)
    inv = torch.empty(gid.shape, dtype=torch.int32, device=dev) \
        .scatter_(-1, order, pos)
    order = order.to(torch.int32)
    lead = tuple(gid.shape[:-1])
    changed = gid_sorted[..., 1:] != gid_sorted[..., :-1]
    if gid2 is not None:
        gid2_sorted = torch.gather(gid2, -1, order.long())
        changed = changed | (gid2_sorted[..., 1:] != gid2_sorted[..., :-1])
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
    dropped = (request_slot < 0) & (dst >= 0)
    counts2 = counts2 if c2 else None
    if cfg.wire_fmt == "planes":
        # the slots are already the plane matrix: transmit moves them
        # without a decode and a re-encode
        return Packed(None, counts1, None, counts2, request_slot, dropped,
                      wire=(s1, s2 if c2 else None, decs)), totals
    slots2 = _decode_words(s2, decs) if c2 else None
    return Packed(_decode_words(s1, decs), counts1, slots2, counts2,
                  request_slot, dropped), totals


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

def _transpose_blocks(leaf: torch.Tensor, c: int,
                      reps: int = 1) -> torch.Tensor:
    """(R*A, B*c, ...) -> (R*B, A*c, ...): within each of the ``reps`` = R
    replicas, block (a, b) of c rows moves from shard a's slot b to shard
    b's slot a — the all_to_all (over the group axis of a sub-axis
    group; R = 1 for a group over the whole mesh, where A may differ
    from B)."""
    trail = tuple(leaf.shape[2:])
    a = leaf.shape[0] // reps
    b = leaf.shape[1] // c
    return leaf.reshape((reps, a, b, c) + trail).transpose(1, 2) \
        .reshape((reps * b, a * c) + trail)


def _a2a(leaf: torch.Tensor, c: int, what: str,
         reps: int = 1) -> torch.Tensor:
    """One counted block transpose (see ``collect_transposes``)."""
    for sink in _transpose_sinks:
        sink.append(what)
    for sink in _transpose_byte_sinks:
        sink.append((what, leaf.numel() * leaf.element_size()))
    return _transpose_blocks(leaf, c, reps)


def _block_meta(cnt: torch.Tensor, c: int, lanes: int):
    """Validity and originating client (T, D*lanes*c) of a transposed
    block of ``c`` rows a (client, lane), from its transposed count header
    (T, D*lanes)."""
    t, n = cnt.shape
    dev = cnt.device
    # contiguous: at c = 1 the reshape would keep the transposed header's
    # strides, and the serve kernels take contiguous rows only
    valid = (torch.arange(c, device=dev) < cnt[..., None]).reshape(
        t, n * c).contiguous()
    client = torch.arange(n // lanes, dtype=torch.int32, device=dev) \
        .repeat_interleave(lanes * c).expand(t, n * c)
    return valid, client


def _transmit_planes(packed: Packed, n_bins: int,
                     cfg: ChannelConfig) -> Received:
    """``transmit`` with ``wire_fmt="planes"``: ONE transpose a block.  The
    plane matrix is the payload's int32 words (``_encode_words``, exact)
    plus one word column of validity from the count header; decoding
    after the transpose gives back the tree format's rows bit for bit."""
    d = packed.counts.shape[0]
    lanes = cfg.n_lanes
    if packed.wire is not None:
        w1, w2, decs = packed.wire
    else:
        w1, decs = _encode_words(packed.slots, d, n_bins * cfg.capacity)
        w2 = None if packed.slots2 is None else _encode_words(
            packed.slots2, d, n_bins * cfg.overflow_capacity)[0]

    def send_block(words, counts, c):
        valid = (torch.arange(c, device=counts.device)
                 < counts[..., None]).reshape(d, n_bins * c, 1)
        planes = _a2a(torch.cat([words, valid.to(torch.int32)], -1),
                      lanes * c, "request", cfg.n_replicas)
        # the client column is static: only the validity rides the wire
        _, client = _block_meta(
            _transpose_blocks(counts, lanes, cfg.n_replicas), c, lanes)
        return _decode_words(planes[..., :-1], decs), planes[..., -1] != 0, \
            client

    rows, valid, client = send_block(w1, packed.counts, cfg.capacity)
    if w2 is not None:
        rows2, valid2, client2 = send_block(w2, packed.counts2,
                                            cfg.overflow_capacity)
        rows = {k: torch.cat([rows[k], rows2[k]], 1) for k in rows}
        valid = torch.cat([valid, valid2], 1)
        client = torch.cat([client, client2], 1)
    return Received(rows, valid, client)


def transmit(packed: Packed, n_bins: int, cfg: ChannelConfig) -> Received:
    """Move request slots to their trustees: the delegation message.
    ``n_bins`` counts destination bins: trustees x ``cfg.n_lanes``."""
    if cfg.wire_fmt == "planes":
        return _transmit_planes(packed, n_bins, cfg)
    lanes, reps = cfg.n_lanes, cfg.n_replicas

    def send_block(slots, counts, c):
        rows = {k: _a2a(v, lanes * c, "request", reps)
                for k, v in slots.items()}
        valid, client = _block_meta(
            _a2a(counts, lanes, "request counts", reps), c, lanes)
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


def respond(responses: Pytree, n_bins: int, cfg: ChannelConfig) -> Pytree:
    """Move response rows back to their clients' slots (the transpose
    back).  Leaves (T, n_chan, ...) -> (D, bins*C [+ bins*C2], ...).
    With ``wire_fmt="planes"`` every leaf rides one word matrix, and the
    rows of ``cfg.elide_lanes`` stay off the transpose and come back as
    zeros."""
    c1, c2 = cfg.capacity, cfg.second_capacity()
    lanes, reps = cfg.n_lanes, cfg.n_replicas
    first = next(iter(responses.values()))
    t = first.shape[0]
    n1 = (first.shape[1] // (c1 + c2)) * c1

    def blocks(leaf, back):
        out = back(leaf[:, :n1], c1)
        if c2:
            out = torch.cat([out, back(leaf[:, n1:], c2)], 1)
        return out

    if cfg.wire_fmt != "planes":
        return {k: blocks(v, lambda x, c: _a2a(x, lanes * c, "response",
                                                 reps))
                for k, v in responses.items()}
    keep = [ln for ln in range(lanes) if ln not in cfg.elide_lanes]
    words, decs = _encode_words(responses, t, first.shape[1])
    wp = words.shape[-1]

    def back(block, c):
        if len(keep) == lanes:
            return _a2a(block, lanes * c, "response", reps)
        d = block.shape[1] // (lanes * c)      # clients of a replica
        n_out, t_rep = reps * d, t // reps     # client shards; trustees
        full = torch.zeros((n_out, t_rep, lanes, c, wp), dtype=words.dtype,
                           device=words.device)
        if keep:
            # the kept lanes by slices: an index list would be copied from
            # the host, which a captured round cannot do
            lanes5 = block.reshape(t, d, lanes, c, wp)
            sub = torch.cat([lanes5[:, :, ln:ln + 1] for ln in keep], 2)
            moved = _a2a(sub.reshape(t, d * len(keep) * c, wp),
                         len(keep) * c, f"response lanes {keep}", reps) \
                .reshape(n_out, t_rep, len(keep), c, wp)
            for j, ln in enumerate(keep):
                full[:, :, ln] = moved[:, :, j]
        return full.reshape(n_out, t_rep * lanes * c, wp)

    return _decode_words(blocks(words, back), decs)


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
    group_sizes: torch.Tensor   # (D, bins) pre-capacity demand per client
    dropped: torch.Tensor       # (D, R) bool — active rows not sent
    #                             (after a drain: still unserved)
    n_rows: int                 # channel rows per shard per round
    impl_fallback: int = 0      # implementation fallbacks in the serve
    rounds: Any = 1             # channel rounds (an int32 device count
    #                             after a drain)
    residual: Any = 0           # rows still unserved over every shard
    #                             (device count after a drain)
    rows_combined: Any = 0      # request rows the combine pass kept off
    #                             the wire, every shard (device count)
    req_bytes_saved: Any = 0    # the request-wire bytes of those rows


def _resp_bytes_per_row(leaf: torch.Tensor, wire_fmt: str) -> int:
    """Wire bytes one response row of this leaf occupies: its own bytes in
    the tree format, one 32-bit word an element in the planes matrix."""
    trailing = 1
    for s in leaf.shape[1:]:
        trailing *= int(s)
    return trailing * (4 if wire_fmt == "planes" else leaf.element_size())


def resp_elision_bytes(resp_like: Pytree, cfg: ChannelConfig,
                       n_rows: int) -> int:
    """Response-transpose bytes per shard saved by elision: whole fields
    no op of the round writes, plus the elided lanes' rows of the other
    fields (multiplexed rounds, "planes" wire)."""
    if not isinstance(resp_like, dict) or n_rows <= 0:
        return 0
    saved = kept_bpr = 0
    for name, leaf in resp_like.items():
        bpr = _resp_bytes_per_row(leaf, cfg.wire_fmt)
        if name in cfg.elide_resp:
            saved += n_rows * bpr
        else:
            kept_bpr += bpr
    if cfg.elide_lanes and cfg.n_lanes > 1 and cfg.wire_fmt == "planes":
        saved += (n_rows // cfg.n_lanes) * len(cfg.elide_lanes) * kept_bpr
    return saved


def _elide_split(resp_rows: Pytree, cfg: ChannelConfig):
    """Split response rows into (kept, elided) by ``cfg.elide_resp``."""
    if not cfg.elide_resp or not isinstance(resp_rows, dict):
        return resp_rows, {}
    kept = {k: v for k, v in resp_rows.items() if k not in cfg.elide_resp}
    elided = {k: v for k, v in resp_rows.items() if k in cfg.elide_resp}
    return kept, elided


def _merge_local(responses: Pytree, local_resp: Pytree,
                 local_mask: torch.Tensor) -> Pytree:
    out = {}
    for k, chan in responses.items():
        m = local_mask.reshape(tuple(local_mask.shape)
                               + (1,) * (chan.dim() - 2))
        out[k] = torch.where(m, local_resp[k], chan)
    return out


def _respond_unpack(resp_rows: Pytree, request_slot: torch.Tensor,
                    n_bins: int, cfg: ChannelConfig,
                    local_resp: Optional[Pytree] = None,
                    local_mask: Optional[torch.Tensor] = None) -> Pytree:
    """respond -> unpack -> merge-local; fields in ``cfg.elide_resp`` skip
    the transpose and come back as zeros (a PUT-only round moves no
    response at all)."""
    kept, elided = _elide_split(resp_rows, cfg)
    out = {}
    if kept:
        out = unpack(respond(kept, n_bins, cfg), request_slot)
        if local_resp is not None:
            out = _merge_local(out, {k: local_resp[k] for k in kept},
                               local_mask)
    shape = tuple(request_slot.shape)
    for k, v in elided.items():
        out[k] = torch.zeros(shape + tuple(v.shape[2:]), dtype=v.dtype,
                             device=v.device)
    return {k: out[k] for k in resp_rows}


def _to_device_slots(dst: torch.Tensor, cfg: ChannelConfig) -> torch.Tensor:
    """Dedicated mode: trustee ids [0, T) become shard slots past the
    ``n_clients`` client shards, and rows that originate on a trustee
    shard (a row's shard is its index on the leading dimension) are masked
    to -1.  With ``n_lanes > 1`` ``dst`` holds virtual bins trustee * L +
    lane, which move by ``n_clients`` whole shard slots (L bins each)."""
    if cfg.mode != "dedicated":
        return dst
    if cfg.n_clients < 1:
        raise ValueError("dedicated mode needs n_clients > 0")
    d = dst.shape[0]
    is_client = torch.arange(d, device=dst.device)[:, None] < cfg.n_clients
    return routing.trustee_device_slot(torch.where(is_client, dst, -1),
                                       cfg.n_clients * cfg.n_lanes)


def _split_local(dst: torch.Tensor, payload: Pytree, n_lanes: int = 1,
                 n_group: Optional[int] = None):
    """Local-trustee shortcut: requests addressed to their own shard skip
    the channel and are appended to that trustee's serve batch, after the
    channel rows (shared mode: client shard d is trustee ``d % n_group``,
    its group index; ``n_group`` defaults to every shard).  With lanes
    ``dst`` holds virtual bins: a row is local when its DEVICE slot
    (``dst // n_lanes``) is its own shard, whichever lane it rides."""
    d, r = dst.shape
    my_id = torch.arange(d, dtype=torch.int32, device=dst.device)[:, None]
    if n_group is not None:
        my_id = my_id % n_group
    local_mask = torch.div(dst, n_lanes, rounding_mode="floor") == my_id
    remote_dst = torch.where(local_mask, torch.full_like(dst, -1), dst)
    local_recv = Received(rows=payload, valid=local_mask,
                          client=my_id.expand(d, r))
    return remote_dst, local_recv, local_mask


def _concat_received(a: Received, b: Received) -> Received:
    return Received(
        rows={k: torch.cat([a.rows[k], b.rows[k]], 1) for k in a.rows},
        valid=torch.cat([a.valid, b.valid], 1),
        client=torch.cat([a.client, b.client], 1))


# ---------------------------------------------------------------------------
# Client-side request combining (the JAX package's DESIGN.md §13)
#
# Between the local-shortcut split and ``pack`` the combine pass groups the
# remote rows of each shard by (destination, op span, key), sends ONE row a
# segment and rebuilds every request's response after unpack:
#
#   dedupe (GET)  the segment's first row rides; its response fans back to
#                 every row of the segment (all read the round-entry value);
#   sum    (ADD)  the first row carries the segment's summed delta; each
#                 row's prior is the combined prior plus the segment-local
#                 exclusive prefix of the original deltas;
#   last   (PUT)  only the segment's last row (the shard's final write)
#                 rides; last-writer-wins across clients is unchanged.
#
# Ops that declare no combine (CAS) pass through as singleton segments.
# ---------------------------------------------------------------------------

_COMBINE_KINDS = ("dedupe", "sum", "last")
_C_DEDUPE, _C_SUM, _C_LAST = 0, 1, 2


class CombineSpan(NamedTuple):
    """The combine plan of one batch span of a round (the engine builds
    one a combinable (trust, op)); rows carry their span in an int32
    column, -1 never combined.  Lane names are wire lane names."""
    kind: str                        # "dedupe" | "sum" | "last"
    key_lane: str                    # wire lane that keys the segment
    sum_lane: Optional[str] = None   # "sum": wire lane of the delta
    resp_tid: Optional[int] = None   # a non-merged multiplexed round's
    #                                  trust (its fields ride "f@tid")
    resp_field: str = "value"        # "sum": the response field rebuilt
    #                                  as combined prior + local prefix


class CombineCtx:
    """What ``RequestCombiner.pre`` hands to ``post`` for one round."""
    __slots__ = ("rep_row", "prefixes", "combined")

    def __init__(self, rep_row, prefixes, combined):
        self.rep_row = rep_row      # (D, R) int32: each row's representative
        self.prefixes = prefixes    # ((response field, (D, R, ...)), ...)
        self.combined = combined    # (D, R) bool: kept off the wire


class RequestCombiner:
    """The combine pass: ``pre`` before ``pack``, ``post`` after unpack.
    A segment never straddles destinations or spans, and only its one
    representative can be dropped or deferred: ``post`` spreads that bit
    over the segment, so a drain retries whole segments."""

    def __init__(self, spans: Tuple[CombineSpan, ...]):
        if not spans:
            raise ValueError("RequestCombiner needs at least one CombineSpan")
        for sp in spans:
            if sp.kind not in _COMBINE_KINDS:
                raise ValueError(f"unknown combine kind {sp.kind!r}")
            if sp.kind == "sum" and sp.sum_lane is None:
                raise ValueError("a 'sum' span needs its sum_lane")
        self.spans = tuple(spans)
        self._kinds = {}

    def kinds(self, dev) -> torch.Tensor:
        """Each span's kind id, int32 on ``dev``: copied from the host
        once a device (the engine asks for it when it builds a round, so
        a captured round copies nothing from the host)."""
        key = str(dev)
        if key not in self._kinds:
            self._kinds[key] = torch.tensor(
                [_COMBINE_KINDS.index(sp.kind) for sp in self.spans],
                dtype=torch.int32, device=dev)
        return self._kinds[key]

    def pre(self, dst: torch.Tensor, rows: Pytree, span_col: torch.Tensor):
        """(dst (D, R), rows, span_col (D, R)) -> (dst', rows', CombineCtx).
        Only active rows of a declared span combine."""
        n = dst.shape[-1]
        dev = dst.device
        pos = torch.arange(n, dtype=torch.int32, device=dev) \
            .expand(dst.shape)
        s = len(self.spans)
        span_col = torch.where(dst >= 0, span_col, -1)
        comb = span_col >= 0
        # the primary key (destination, span) is small; the op's key rides
        # as the secondary sort key; rows not combined are singletons
        k1 = torch.where(comb, dst * s + span_col, -1).to(torch.int32)
        key_col = torch.zeros(dst.shape, dtype=torch.int32, device=dev)
        for sid, sp in enumerate(self.spans):
            key_col = torch.where(span_col == sid,
                                  rows[sp.key_lane].to(torch.int32), key_col)
        g = make_grouping(k1, gid2=torch.where(comb, key_col, pos))
        seg_start_row = torch.gather(g.seg_start, -1, g.inv.long())
        is_first = g.inv == seg_start_row
        is_last = g.inv == g.seg_end_row - 1
        kinds = self.kinds(dev)
        keep_last = kinds[torch.clamp(span_col, 0, s - 1).long()] == _C_LAST
        is_rep = torch.where(comb, torch.where(keep_last, is_last, is_first),
                             True)
        new_dst = torch.where(comb & ~is_rep, -1, dst)
        new_rows = dict(rows)
        prefixes = []
        for sid, sp in enumerate(self.spans):
            if sp.kind != "sum":
                continue
            m = comb & (span_col == sid)
            leaf = rows[sp.sum_lane]
            delta = _where_rows(m, leaf, torch.zeros_like(leaf))
            # a global cumsum of the sorted deltas minus the segment base
            d_s = take_rows(delta, g.order)
            incl = torch.cumsum(d_s, dim=1)
            excl = incl - d_s
            seg_base = take_rows(excl, g.seg_start)
            prefix = take_rows(excl - seg_base, g.inv)
            total = take_rows(take_rows(incl, torch.clamp(g.seg_end - 1, 0,
                                                          n - 1))
                              - seg_base, g.inv)
            # the representative (the segment's first row) sends the sum
            new_rows[sp.sum_lane] = _where_rows(m & is_rep, total,
                                                new_rows[sp.sum_lane])
            field = sp.resp_field if sp.resp_tid is None \
                else f"{sp.resp_field}@{sp.resp_tid}"
            prefixes.append((field, _where_rows(m, prefix,
                                                torch.zeros_like(prefix))))
        rep_sorted = torch.where(keep_last, g.seg_end_row - 1, seg_start_row)
        rep_row = torch.where(comb, torch.gather(g.order, -1,
                                                 rep_sorted.long()), pos)
        return new_dst, new_rows, CombineCtx(rep_row, tuple(prefixes),
                                             comb & ~is_rep)

    def post(self, responses: Pytree, dropped: torch.Tensor,
             ctx: CombineCtx):
        """Spread the representative's dropped bit over its segment, then
        ``fan_out``.  Returns (responses', dropped')."""
        dropped2 = torch.gather(dropped, -1, ctx.rep_row.long())
        return self.fan_out(responses, dropped2, ctx), dropped2

    def fan_out(self, responses: Pytree, dropped: torch.Tensor,
                ctx: CombineCtx) -> Pytree:
        """Fan each representative's response back over its segment and
        add the sum archetype's prefixes to the served rows; ``dropped``
        is already spread over the segments (``post``'s second result)."""
        rep = ctx.rep_row.long()
        out = {k: take_rows(v, rep) for k, v in responses.items()}
        served = ~dropped
        for field, pref in ctx.prefixes:
            out[field] = out[field] + _where_rows(served, pref,
                                                  torch.zeros_like(pref))
        return out


def as_combine_decl(c) -> Tuple[str, str, str, str]:
    """An op's combine declaration (an ``opspec.Combine`` or the
    "dedupe" / "sum" / "last" shorthand) as ``(kind, key_field,
    sum_field, resp_field)``."""
    if isinstance(c, str):
        kind, key, field, resp = c, "key", "value", "value"
    else:
        kind, key, field, resp = c.kind, c.key, c.field, c.resp
    if kind not in _COMBINE_KINDS:
        raise ValueError(f"unknown combine kind {kind!r}; "
                         f"expected one of {_COMBINE_KINDS}")
    return kind, key, field, resp


def _req_bytes_per_row(rows: Pytree, wire_fmt: str) -> int:
    """Request-wire bytes one row of this payload (leaves (D, R, ...))
    takes: its own bytes in the tree format, a 32-bit word an element on
    the "planes" wire (JAX counts 8 bytes for an int32 element there, its
    hi/lo planes; the port's wire moves 4)."""
    total = 0
    for leaf in rows.values():
        n = 1
        for s in leaf.shape[2:]:
            n *= int(s)
        total += n * (4 if wire_fmt == "planes" else leaf.element_size())
    return total


class DelegationFuture(NamedTuple):
    """``delegate_async``'s deferred half (the JAX channel's
    ``apply_then``, the paper's §4.2): the serve has run and the tables
    are written; ``wait()`` moves the responses back, unpacks them into
    request order, merges the shortcut's rows and undoes the combine
    pass, returning what ``delegate`` returns for the same call.  In JAX
    the gap gives XLA's scheduler room to overlap the response collective
    with the client's work; on one card the ops are issued when
    ``wait()`` is called.  ``resp_rows`` is None when every row took the
    shortcut (one trustee slot): ``wait()`` returns ``local_resp``.
    ``dropped`` is ``ChannelInfo.dropped``: with a combine pass, each
    row's segment's bit, which ``fan_out`` reads."""
    resp_rows: Optional[Pytree]
    request_slot: Optional[torch.Tensor]
    n_bins: int
    cfg: ChannelConfig
    local_resp: Optional[Pytree] = None
    local_mask: Optional[torch.Tensor] = None
    combiner: Optional[RequestCombiner] = None
    combine_ctx: Optional[CombineCtx] = None
    dropped: Optional[torch.Tensor] = None

    def wait(self) -> Pytree:
        if self.resp_rows is None:
            return self.local_resp
        out = _respond_unpack(self.resp_rows, self.request_slot,
                              self.n_bins, self.cfg, self.local_resp,
                              self.local_mask)
        if self.combine_ctx is not None:
            out = self.combiner.fan_out(out, self.dropped, self.combine_ctx)
        return out


def delegate_async(state: Pytree, dst: torch.Tensor, payload: Pytree,
                   serve_fn: ServeFn, n_trustees: int, cfg: ChannelConfig,
                   combine: Optional[RequestCombiner] = None,
                   combine_span: Optional[torch.Tensor] = None):
    """pack -> transmit -> serve over every shard at once, the response
    half deferred: returns (new_state, DelegationFuture, ChannelInfo)
    right after the serve (JAX's ``delegate_async``).  ``dst`` (D, R)
    holds trustee ids — virtual bins ``trustee * n_lanes + lane`` when
    ``cfg.n_lanes > 1``, so each lane keeps its solo pack, capacity and
    FIFO semantics inside the shared block.  In dedicated mode they
    become shard slots past the clients, rows on trustee shards are
    masked off and there is no shortcut.  ``combine`` / ``combine_span``
    (with ``cfg.combine_impl != "off"``) run the combine pass between the
    shortcut split and the pack, so ``group_sizes`` is the post-combine
    demand and ``dropped`` each row's segment's.  ``group_sizes`` is per
    bin."""
    d, r = dst.shape
    n_slots = cfg.n_slots(n_trustees)
    n_bins = n_slots * cfg.n_lanes
    dst = _to_device_slots(dst, cfg)
    local_recv = local_mask = None
    if cfg.local_shortcut and cfg.mode != "dedicated":
        dst, local_recv, local_mask = _split_local(
            dst, payload, cfg.n_lanes,
            n_slots if cfg.n_replicas > 1 else None)
        if n_slots == 1:
            with collect_impl_events() as events:
                new_state, local_resp = serve_fn(state, local_recv)
            info = ChannelInfo(
                torch.zeros((d, n_bins), dtype=torch.int32,
                            device=dst.device),
                torch.zeros((d, r), dtype=torch.bool, device=dst.device), 0,
                impl_fallback=len(events))
            return new_state, DelegationFuture(None, None, n_bins, cfg,
                                               local_resp), info

    cctx = None
    if combine is not None and combine_span is not None \
            and cfg.combine_impl != "off":
        # shortcut rows kept the payload as it was: they serve one by one,
        # after the channel rows, as with combining off
        dst, payload, cctx = combine.pre(dst, payload, combine_span)

    packed, group_sizes = pack(dst, payload, n_bins, cfg)
    received = transmit(packed, n_bins, cfg)
    n_chan = received.valid.shape[1]
    if local_recv is not None:
        received = _concat_received(received, local_recv)
    with collect_impl_events() as events:
        new_state, resp_rows = serve_fn(state, received)
    local_resp = None
    if local_recv is not None:
        local_resp = {k: v[:, n_chan:] for k, v in resp_rows.items()}
        resp_rows = {k: v[:, :n_chan] for k, v in resp_rows.items()}
    dropped = packed.dropped
    rows_combined = req_bytes_saved = 0
    if cctx is not None:
        # a segment's rows share its representative's fate
        dropped = torch.gather(dropped, -1, cctx.rep_row.long())
        # replica 0's count (JAX's psum over the group axis)
        rows_combined = cctx.combined[:d // cfg.n_replicas].sum(
            dtype=torch.int32)
        req_bytes_saved = rows_combined * _req_bytes_per_row(payload,
                                                             cfg.wire_fmt)
    fut = DelegationFuture(resp_rows, packed.request_slot, n_bins, cfg,
                           local_resp, local_mask,
                           combiner=combine if cctx is not None else None,
                           combine_ctx=cctx, dropped=dropped)
    info = ChannelInfo(group_sizes, dropped, n_bins * cfg.total_capacity(),
                       impl_fallback=len(events),
                       rows_combined=rows_combined,
                       req_bytes_saved=req_bytes_saved)
    return new_state, fut, info


def delegate(state: Pytree, dst: torch.Tensor, payload: Pytree,
             serve_fn: ServeFn, n_trustees: int, cfg: ChannelConfig,
             combine: Optional[RequestCombiner] = None,
             combine_span: Optional[torch.Tensor] = None):
    """Synchronous delegation: pack -> transmit -> serve -> respond ->
    unpack over every shard at once (``delegate_async``, then its
    future's ``wait()``).  Returns (new_state, responses (D, R, ...),
    ChannelInfo)."""
    new_state, fut, info = delegate_async(state, dst, payload, serve_fn,
                                          n_trustees, cfg, combine=combine,
                                          combine_span=combine_span)
    return new_state, fut.wait(), info


def _check_retry_serve(state: Pytree, payload: Pytree, serve_fn: ServeFn,
                       n_bins: int, cfg: ChannelConfig, d: int) -> None:
    """Run a drain retry round's serve on rows of its shape with no row
    valid, its launches discarded: every check a retry round's serve makes
    before its launches raises now, before round 1 writes a table in
    place.  Only the local shortcut gives round 1 another shape than its
    retry rounds (they carry no shortcut tail); otherwise round 1's own
    checks are theirs."""
    n = n_bins * cfg.total_capacity()
    dev = next(iter(payload.values())).device
    rows = {k: torch.zeros((d, n) + tuple(v.shape[2:]), dtype=v.dtype,
                           device=dev) for k, v in payload.items()}
    probe = Received(rows, torch.zeros((d, n), dtype=torch.bool, device=dev),
                     torch.zeros((d, n), dtype=torch.int32, device=dev))
    with deferred_launches():
        serve_fn(state, probe)


def delegate_drain(state: Pytree, dst: torch.Tensor, payload: Pytree,
                   serve_fn: ServeFn, n_trustees: int, cfg: ChannelConfig,
                   max_rounds: Optional[int] = None,
                   combine: Optional[RequestCombiner] = None,
                   combine_span: Optional[torch.Tensor] = None):
    """The defer drain (``overflow="defer"``; the paper's §5.1 "wait for
    slot availability" as bounded retry rounds).

    Round 1 is a full ``delegate`` (the local shortcut included).  The
    rows it deferred are re-packed and re-sent in up to ``max_rounds -
    1`` retry rounds, without the shortcut; responses merge into request
    order, and FIFO per (client, trustee) holds across rounds (each round
    serves a pair's next ``capacity`` rows).  JAX loops while rows remain;
    the port issues every retry round, each masked by the rows still
    remaining, so no device value is read back on the host: a round with
    none left sends nothing, leaves tables and responses as they are, and
    is not counted.  ``info.rounds`` (rounds that carried rows, as JAX
    counts them) and ``info.residual`` (rows still unserved; they keep
    zero responses and stay set in ``info.dropped``) are device counts."""
    if cfg.overflow != "defer":
        raise ValueError(f"delegate_drain needs overflow='defer', got "
                         f"{cfg.overflow!r}")
    max_rounds = cfg.max_rounds if max_rounds is None else max_rounds
    if max_rounds < 1:
        raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
    cfg_retry = dataclasses.replace(cfg, local_shortcut=False)
    if max_rounds > 1 and cfg.local_shortcut and cfg.mode != "dedicated":
        _check_retry_serve(state, payload, serve_fn,
                           cfg.n_slots(n_trustees) * cfg.n_lanes, cfg_retry,
                           dst.shape[0])
    state, responses, info = delegate(state, dst, payload, serve_fn,
                                      n_trustees, cfg, combine=combine,
                                      combine_span=combine_span)
    # each replica drains on its own (JAX's loop condition is a psum over
    # the group axis): the counts are per replica, replica 0's reported
    n_reps = cfg.n_replicas

    def left(remaining):
        return remaining.reshape(n_reps, -1).sum(-1, dtype=torch.int32)

    remaining = info.dropped
    total = left(remaining)
    rounds = torch.ones((n_reps,), dtype=torch.int32, device=dst.device)
    if max_rounds == 1:
        return state, responses, info._replace(rounds=rounds[0],
                                               residual=total[0])
    combined, saved = info.rows_combined, info.req_bytes_saved
    for _ in range(max_rounds - 1):
        rounds = rounds + (total > 0).to(torch.int32)
        # a deferred segment stays whole (post marks all of it), so the
        # retried rows re-form the same segments
        state, resp_r, info_r = delegate(
            state, torch.where(remaining, dst, -1), payload, serve_fn,
            n_trustees, cfg_retry, combine=combine,
            combine_span=combine_span)
        sent = remaining & ~info_r.dropped
        responses = {k: _where_rows(sent, resp_r[k], v)
                     for k, v in responses.items()}
        remaining = info_r.dropped
        total = left(remaining)
        combined = combined + info_r.rows_combined
        saved = saved + info_r.req_bytes_saved
    return state, responses, info._replace(
        dropped=remaining, rounds=rounds[0], residual=total[0],
        rows_combined=combined, req_bytes_saved=saved)


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


def _serve_members(serves, states, members):
    """Serve each trust's ``Received``; every kernel launch waits until all
    members' pre-launch checks have passed, so a round that raises leaves
    every member's state as it was."""
    new_states, resps = [], []
    with deferred_launches() as launches:
        for serve_t, state, recv_t in zip(serves, states, members):
            s, r = serve_t(state, recv_t)
            new_states.append(s)
            resps.append(r)
    for fn in launches:
        # an enclosing deferral (a drain's check of its retry serve) takes
        # the launches; otherwise they run now
        launch_or_defer(fn)
    return tuple(new_states), resps


def _where_rows(m: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    return torch.where(m.reshape(tuple(m.shape) + (1,) * (a.dim() - m.dim())),
                       a, b)


def serve_multiplex(tables, renames, merge_resp: bool = False,
                    serve_impl: str = "kernel",
                    cfg: Optional[ChannelConfig] = None) -> ServeFn:
    """Merged serve table for one MULTIPLEXED round over several Trusts,
    the masked layout (see ``repro.core.channel.serve_multiplex``).

    ``states`` is a tuple of per-trust states; the rows carry a "trust"
    lane next to the "op" lane, and trust ``tid``'s payload field ``f``
    rides the wire lane ``renames[tid][f]``.  Trust ``tid`` serves the
    rows where ``trust == tid`` through its own op table with its own
    state, in (registration, op-table) order.  With ``merge_resp`` (every
    trust's responses agree in structure) one response dict carries each
    row's own trust's response; otherwise the dict holds every trust's
    fields as ``field@tid``."""
    serves = tuple(serve_optable(ops, active, serve_impl=serve_impl, cfg=cfg)
                   for ops, active in tables)

    def serve(states, received: Received):
        rows = received.rows
        trust_col = rows["trust"]
        members = []
        for tid in range(len(serves)):
            rows_t = {"op": rows["op"]} if "op" in rows else {}
            for field, lane in renames[tid].items():
                rows_t[field] = rows[lane]
            members.append(Received(rows_t, received.valid & (trust_col == tid),
                                    received.client))
        new_states, resps = _serve_members(serves, states, members)
        if merge_resp:
            out = resps[0]
            for tid in range(1, len(resps)):
                m = trust_col == tid
                out = {k: _where_rows(m, v, out[k])
                       for k, v in resps[tid].items()}
            return new_states, out
        return new_states, {f"{k}@{tid}": v for tid, r in enumerate(resps)
                            for k, v in r.items()}
    return serve


def lane_rows(leaf: torch.Tensor, tid: int, n_lanes: int, t_send: int,
              c1: int, c2: int) -> torch.Tensor:
    """The rows of lane ``tid`` in a received buffer of the lane layout
    (T, t_send*n_lanes*(c1 + c2) [+ local tail], ...): its ``c1`` rows of
    every client block, its ``c2`` rows of every second_round block, then
    the whole local-shortcut tail — gathered once into a contiguous
    tensor (the serve kernels take contiguous rows only)."""
    t = leaf.shape[0]
    trail = tuple(leaf.shape[2:])
    n1, n2 = t_send * n_lanes * c1, t_send * n_lanes * c2

    def block(part, c):
        return part.reshape((t, t_send, n_lanes, c) + trail)[:, :, tid] \
            .reshape((t, t_send * c) + trail)

    parts = [block(leaf[:, :n1], c1)]
    if n2:
        parts.append(block(leaf[:, n1:n1 + n2], c2))
    if leaf.shape[1] > n1 + n2:
        parts.append(leaf[:, n1 + n2:])
    return torch.cat(parts, 1) if len(parts) > 1 else parts[0].contiguous()


def serve_multiplex_strided(tables, renames, n_lanes: int, t_send: int,
                            c1: int, c2: int, serve_impl: str = "kernel",
                            cfg: Optional[ChannelConfig] = None) -> ServeFn:
    """``serve_multiplex`` for the LANE slot layout (``cfg.n_lanes > 1``):
    each trust serves only its own ``t_send * (c1 + c2)`` channel rows plus
    the local-shortcut tail, so the serve work stays linear in the number
    of trusts; the per-trust responses restack into one buffer (every
    trust's response structure must match)."""
    serves = tuple(serve_optable(ops, active, serve_impl=serve_impl, cfg=cfg)
                   for ops, active in tables)
    n1, n2 = t_send * n_lanes * c1, t_send * n_lanes * c2

    def serve(states, received: Received):
        rows, valid, client = received.rows, received.valid, received.client
        n_local = valid.shape[1] - n1 - n2
        if n_local < 0:
            raise ValueError("strided multiplex serve called with a "
                             "non-lane row layout")
        trust_col = rows.get("trust")
        if n_local and trust_col is None:
            raise ValueError("a local-shortcut tail needs the trust lane on "
                             "the wire")

        def sub(leaf, tid):
            return lane_rows(leaf, tid, n_lanes, t_send, c1, c2)

        members = []
        for tid in range(len(serves)):
            rows_t = {"op": sub(rows["op"], tid)} if "op" in rows else {}
            for field, lane in renames[tid].items():
                rows_t[field] = sub(rows[lane], tid)
            valid_t = sub(valid, tid)
            if trust_col is not None:
                # channel rows of lane tid always carry trust == tid; the
                # mask only bites on the shared local-shortcut tail
                valid_t = valid_t & (sub(trust_col, tid) == tid)
            members.append(Received(rows_t, valid_t, sub(client, tid)))
        new_states, resps = _serve_members(serves, states, members)

        t = valid.shape[0]
        tail_trust = trust_col[:, n1 + n2:] if n_local else None

        def join(leaves):
            shp = tuple(leaves[0].shape[2:])
            o1 = t_send * c1
            parts = [torch.stack(
                [x[:, :o1].reshape((t, t_send, c1) + shp) for x in leaves],
                2).reshape((t, n1) + shp)]
            if n2:
                parts.append(torch.stack(
                    [x[:, o1:o1 + t_send * c2].reshape((t, t_send, c2) + shp)
                     for x in leaves], 2).reshape((t, n2) + shp))
            if n_local:
                o_l = t_send * (c1 + c2)
                tail = leaves[0][:, o_l:]
                for tid in range(1, len(leaves)):
                    tail = _where_rows(tail_trust == tid,
                                       leaves[tid][:, o_l:], tail)
                parts.append(tail)
            return torch.cat(parts, 1) if len(parts) > 1 else parts[0]

        return new_states, {k: join([r[k] for r in resps]) for k in resps[0]}
    return serve
