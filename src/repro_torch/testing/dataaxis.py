"""A sub-axis KV store driven so that each data row issues its own stream,
held to a sequential oracle per data row.

A store over the ``"model"`` axis of a (R, T) mesh keeps R replicas of
its table, and a round mutates replica r with data row r's requests only
(``core.trust``).  The engine gives each of the mesh's R * T shards a
contiguous slice of the fused batch, so a round whose batches are data
row 0's, then row 1's, ..., each row's rows a multiple of T in all, hands
every data row exactly its own batches.  Replica r then equals a
``SequentialKVReference`` fed row r's batches in serve order: per op
batch, the channel rows in (client, slot) order, the local shortcut's
rows after them (the order ``tests/_diff_battery.py`` gives the oracle).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Batch = Tuple[str, np.ndarray, np.ndarray, np.ndarray]   # op, keys, vals,
#                                                          expect (CAS)


def fused_round(rows: Sequence[Sequence[Batch]], n_group: int
                ) -> List[Batch]:
    """The round's op batches, data row by data row; each row's rows must
    total the same multiple of ``n_group``, else a shard would hold rows
    of two data rows."""
    sizes = {sum(len(b[1]) for b in row) for row in rows}
    if len(sizes) != 1 or next(iter(sizes)) % n_group:
        raise ValueError(f"each data row's batches must hold the same "
                         f"multiple of {n_group} rows, got {sorted(sizes)}")
    return [b for row in rows for b in row]


def submit(torch, dev, store, batches: Sequence[Batch]):
    """Queue the batches on the store's typed handles (inactive rows carry
    key -1); returns the futures."""
    op = store.trust.op

    def t(a):
        return torch.as_tensor(a, device=dev)
    futs = []
    for name, keys, vals, expect in batches:
        live = t(keys >= 0)
        k = t(np.maximum(keys, 0).astype(np.int32))
        if name == "get":
            futs.append(op.get.then(k, where=live))
        elif name == "put":
            futs.append(op.put.then(k, t(vals), where=live))
        elif name == "add":
            futs.append(op.add.then(k, t(vals), where=live))
        else:
            futs.append(op.cas.then(k, value=t(vals), expect=t(expect),
                                    where=live))
    return futs


def responses(futs, batches) -> List[object]:
    """The futures' results on the host, as ``row_oracle`` gives them
    (None for a PUT, (flag, value) for a CAS)."""
    out = []
    for fut, (name, *_r) in zip(futs, batches):
        r = fut.result()
        if name == "put":
            out.append(None)
        elif name == "cas":
            out.append((r["flag"].cpu().numpy(), r["value"].cpu().numpy()))
        else:
            out.append(r["value"].cpu().numpy())
    return out


def row_oracle(ref, batches: Sequence[Batch], shortcut: bool,
               n_group: int) -> List[object]:
    """Replay one data row's batches of a round on its oracle in serve
    order: the row's rows split over its ``n_group`` client shards in
    contiguous slices, key k owned by trustee ``k % n_group``; under the
    local shortcut a batch's self-addressed rows serve after its channel
    rows.  Responses in request order."""
    sizes = [len(b[1]) for b in batches]
    r_dev = -(-sum(sizes) // n_group)
    out, off = [], 0
    for (op, keys, vals, expect), n in zip(batches, sizes):
        perm = np.arange(n)
        if shortcut:
            client = (off + np.arange(n)) // r_dev
            local = (keys >= 0) & ((keys % n_group) == client)
            perm = np.concatenate([np.where(~local)[0], np.where(local)[0]])
        off += n
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        k = keys[perm]
        if op == "get":
            out.append(ref.get(k)[inv])
        elif op == "put":
            ref.put(k, vals[perm])
            out.append(None)
        elif op == "add":
            out.append(ref.add(k, vals[perm])[inv])
        else:
            fl, old = ref.cas(k, expect[perm], vals[perm])
            out.append((fl[inv].astype(np.int32), old[inv]))
    return out


def same(a, b) -> bool:
    """Two round results (``responses`` / ``row_oracle``) equal bit for
    bit."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, tuple):
        return all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(a, b))
    return np.array_equal(a, b)


def replica_tables(store) -> List[np.ndarray]:
    """Each replica's table in key order (replica 0 is ``store.dump()``)."""
    table = store.trust.state()["table"].cpu().numpy()
    t = store.t
    return [rep.transpose(1, 0, 2).reshape(-1, table.shape[-1])
            [:store.n_keys].copy()
            for rep in table.reshape((-1, t) + table.shape[1:])]
