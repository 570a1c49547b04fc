"""PagedDecodeDriver — continuous-batching decode over the delegated
page table (the torch counterpart of ``repro.launch.paged_serve``).

A ``StreamingDriver`` whose every wave is ONE engine round carrying the
whole page-table op mix for the wave's continuous batch:

  free(finished)  +  alloc(newly admitted prompts)  +
  append(every decoding seq's next token)  +  lookup(their chains)

The op-phase order (alloc, append, free, lookup) means a wave's
``lookup`` observes that same wave's ``alloc``/``append``: one round hands
the decode step both its KV write slot and the full block-sparse page list
the paged-attention kernel consumes.  Model compute hooks in through two
callbacks, run when the wave is CONSUMED (the responses become numpy
there, the wave's one host sync):

  on_prefill(seqs, lengths, chains)   — write prompt KV into the pages
  on_decode(seqs, positions, chains)  — one decode step per sequence

Eviction is survivable: the page table may evict a victim sequence under
capacity pressure; the victim's next ``append`` re-allocs its whole chain
(the schema's healing semantics), the driver notices the unexpected
allocation count and replays the prompt KV via ``on_prefill`` (counted in
``restarts``)."""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .streaming import AdmissionControl, StreamingDriver

PENDING, PREFILL, DECODE, DONE, FAILED = range(5)


@dataclass
class DecodeRequest:
    """One user request stream: ``prompt_len`` tokens of prefill, then
    ``gen_len`` decode steps."""
    rid: int
    prompt_len: int
    gen_len: int
    user: Any = None
    arrived: float = 0.0
    seq: int = -1
    state: int = PENDING
    next_pos: int = 0          # submit clock: next token position to append
    decoded: int = 0           # consume clock: tokens actually served
    done_at: float = -1.0

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.gen_len


class PagedDecodeDriver(StreamingDriver):
    """Continuous-batching driver over one ``DelegatedPageTable``.

    ``submit()`` enqueues requests; ``step_wave()`` runs one fused engine
    round (admit + append + lookup + retire); ``run()`` loops until every
    request finishes.  ``max_active`` bounds the continuous batch;
    admission additionally respects the page-pressure heuristic (a new
    prompt is admitted only while its worst-case chain fits the free
    pool) and the inherited row-token ledger with per-user buckets."""

    def __init__(self, pagetable, depth: int = 1,
                 admission: Optional[AdmissionControl] = None,
                 on_prefill: Optional[Callable] = None,
                 on_decode: Optional[Callable] = None,
                 max_active: Optional[int] = None):
        super().__init__(pagetable.session, depth=depth,
                         admission=admission)
        self.pagetable = pagetable
        self.on_prefill = on_prefill
        self.on_decode = on_decode
        self.max_active = max_active or pagetable.max_seqs
        self.queue: deque = deque()
        self.active: Dict[int, DecodeRequest] = {}
        self.finished: List[DecodeRequest] = []
        self._free_seqs = list(range(pagetable.max_seqs - 1, -1, -1))
        self._to_free: List[int] = []
        self._freeing: Dict[int, int] = {}   # seq -> page estimate to return
        self._est_pages = 0                  # global page-pressure estimate
        self._owner_est: Dict[int, int] = {}  # per-trustee page estimate
        self.tokens = 0
        self.pt_rows = 0
        self.restarts = 0
        self.failed = 0

    # -- request intake ----------------------------------------------------
    def submit(self, req: DecodeRequest) -> None:
        if req.arrived == 0.0:
            req.arrived = time.perf_counter()
        pt = self.pagetable
        if req.total_len > pt.max_pages * pt.page_size:
            # can never fit in one chain — reject now instead of wedging
            # the FIFO head forever
            req.state = FAILED
            self.failed += 1
            self.finished.append(req)
            return
        self.queue.append(req)

    def _pages_for(self, tokens: int) -> int:
        ps = self.pagetable.page_size
        return -(-max(tokens, 1) // ps)

    def _local_cap(self, owner: int) -> int:
        """Non-phantom pages owned by one trustee (global ids ≡ owner mod T)."""
        t, n = self.pagetable.t, self.pagetable.n_pages
        return max(0, (n - owner + t - 1) // t)

    def _pick_seq(self, need: int) -> Optional[int]:
        """Choose a free sequence id whose OWNER trustee still has room for
        the worst-case chain.  Sequence→trustee is ``seq % T``, so the global
        estimate alone cannot see per-trustee pressure — two long chains
        landing on one owner would evict each other every wave."""
        t = self.pagetable.t
        for i in range(len(self._free_seqs) - 1, -1, -1):  # lowest ids first
            s = self._free_seqs[i]
            o = s % t
            if self._owner_est.get(o, 0) + need <= self._local_cap(o):
                return self._free_seqs.pop(i)
        return None

    # -- one fused wave ------------------------------------------------------
    def step_wave(self) -> int:
        """Build and dispatch ONE engine round for the current batch.
        Returns the number of page-table rows it carried (0 = idle)."""
        pt = self.pagetable
        subs: List[Tuple[str, np.ndarray, Any]] = []
        rows = 0
        users: Dict[Any, int] = {}

        def bill(reqs, n_rows_each):
            nonlocal rows
            for r in reqs:
                rows += n_rows_each
                if r.user is not None:
                    users[r.user] = users.get(r.user, 0) + n_rows_each

        # retire: frees scheduled by earlier consumes
        if self._to_free:
            seqs = np.array(sorted(self._to_free), np.int32)
            self._to_free.clear()
            rows += len(seqs)
            subs.append(("free", seqs, pt.free_then(seqs)))

        # admit: new prompts while a seq id is free and the worst-case
        # chain fits the pool (soft bound — eviction is the backstop)
        admitted: List[DecodeRequest] = []
        while (self.queue and self._free_seqs
               and len(self.active) + len(admitted) < self.max_active):
            req = self.queue[0]
            need = self._pages_for(req.total_len)
            if self._est_pages + need > pt.n_pages:
                break
            seq = self._pick_seq(need)
            if seq is None:
                break                        # every feasible owner is full
            self.queue.popleft()
            req.seq = seq
            req.state = PREFILL
            req.next_pos = req.prompt_len
            self._est_pages += need
            self._owner_est[seq % pt.t] = \
                self._owner_est.get(seq % pt.t, 0) + need
            self.active[req.seq] = req
            admitted.append(req)
        if admitted:
            seqs = np.array([r.seq for r in admitted], np.int32)
            ks = np.array([self._pages_for(r.prompt_len) for r in admitted],
                          np.int32)
            bill(admitted, 1)
            subs.append(("alloc", seqs, pt.alloc_then(seqs, ks)))

        # decode: one append + one lookup per decoding sequence
        decoding = [r for r in self.active.values()
                    if r.state == DECODE and r.next_pos < r.total_len]
        if decoding:
            decoding.sort(key=lambda r: r.seq)
            seqs = np.array([r.seq for r in decoding], np.int32)
            poss = np.array([r.next_pos for r in decoding], np.int32)
            for r in decoding:
                r.next_pos += 1
            bill(decoding, 2)
            fa = pt.append_then(seqs, poss)
            fl = pt.lookup_then(seqs)
            subs.append(("decode", seqs, (poss, fa, fl)))

        if not subs:
            return 0
        self.pt_rows += rows
        self.admit(rows, users or None)
        outs = [s[-1] for s in subs[:-1]]
        outs += [subs[-1][-1]] if subs[-1][0] != "decode" else \
            list(subs[-1][-1][1:])
        self.dispatch(outputs=outs, rows=rows, users=users or None,
                      on_consume=lambda h, subs=subs: self._on_wave(h, subs))
        return rows

    # -- consume-side bookkeeping -------------------------------------------
    def _on_wave(self, h, subs) -> None:
        pt = self.pagetable
        ps = pt.page_size
        for kind, seqs, extra in subs:
            if kind == "free":
                # only NOW may the seq ids be reused: a free re-submitted
                # earlier would run AFTER a reuser's alloc in the same wave
                # (phase order) and wipe the fresh chain
                t = pt.t
                for s in seqs:
                    s = int(s)
                    need = self._freeing.pop(s, 0)
                    self._est_pages -= need
                    o = s % t
                    self._owner_est[o] = max(
                        0, self._owner_est.get(o, 0) - need)
                    self._free_seqs.append(s)
                continue
            if kind == "alloc":
                resp = pt.globalize(extra.result(), seqs, fields=("pages",))
                ok = np.asarray(resp["flag"]) > 0
                pre_s, pre_l, pre_c = [], [], []
                for i, s in enumerate(seqs):
                    req = self.active.get(int(s))
                    if req is None:
                        continue
                    if not ok[i]:
                        self._drop(req, h)
                        continue
                    req.state = DECODE
                    pre_s.append(int(s))
                    pre_l.append(req.prompt_len)
                    pre_c.append(resp["pages"][i])
                if pre_s and self.on_prefill is not None:
                    self.on_prefill(np.array(pre_s, np.int32),
                                    np.array(pre_l, np.int32),
                                    np.stack(pre_c))
                continue
            poss, fa, fl = extra
            ra = pt.globalize(fa.result(), seqs, fields=("page",))
            rl = pt.globalize(fl.result(), seqs, fields=("pages",))
            flag = np.asarray(ra["flag"])
            dec_s, dec_p, dec_c = [], [], []
            for i, s in enumerate(seqs):
                req = self.active.get(int(s))
                if req is None:
                    continue
                p = int(poss[i])
                if flag[i] < 0:
                    # table genuinely full even after eviction: fail fast
                    self._drop(req, h)
                    continue
                expected = 1 if p % ps == 0 else 0
                healed = int(flag[i]) != expected
                chain = rl["pages"][i]
                # the chain can also be wiped AFTER this seq's append by a
                # LATER row's eviction in the same round (phase order puts
                # every append before the lookups): the token's KV slot is
                # gone, so skip on_decode — the seq's next append heals the
                # chain and the flag-mismatch replay below rewrites every
                # position through it
                have = (int(rl["n"][i]) > p // ps) and chain[p // ps] >= 0
                if healed or not have:
                    self.restarts += 1
                if healed and have and self.on_prefill is not None:
                    # evicted earlier, chain healed by this append's
                    # multi-page re-alloc: replay the KV for 0..p-1
                    self.on_prefill(np.array([int(s)], np.int32),
                                    np.array([p], np.int32), chain[None])
                if have:
                    dec_s.append(int(s))
                    dec_p.append(p)
                    dec_c.append(chain)
                req.decoded += 1
                self.tokens += 1
                if req.decoded >= req.gen_len:
                    req.state = DONE
                    req.done_at = h.consumed_at
                    self._retire(req)
            if dec_s and self.on_decode is not None:
                self.on_decode(np.array(dec_s, np.int32),
                               np.array(dec_p, np.int32),
                               np.stack(dec_c))

    def _retire(self, req: DecodeRequest) -> None:
        self.active.pop(req.seq, None)
        self._to_free.append(req.seq)
        self._freeing[req.seq] = self._pages_for(req.total_len)
        self.finished.append(req)

    def _drop(self, req: DecodeRequest, h) -> None:
        req.state = FAILED
        req.done_at = h.consumed_at
        self.failed += 1
        self._retire(req)

    # -- whole-trace loop ----------------------------------------------------
    def run(self, requests, max_waves: Optional[int] = None) -> Dict[str, Any]:
        for r in requests:
            self.submit(r)
        waves = 0
        while self.queue or self.active:
            if self.step_wave() == 0:
                if self._inflight:
                    self._consume_oldest()   # let consumes unblock the batch
                    continue
                break                        # stuck (nothing admissible)
            waves += 1
            if max_waves is not None and waves >= max_waves:
                break
        self.drain()
        # flush the trailing frees so the table ends clean
        while self._to_free:
            self.step_wave()
            self.drain()
        return self.serve_stats()

    def serve_stats(self) -> Dict[str, Any]:
        out = self.stats()
        lat = [r.done_at - r.arrived for r in self.finished
               if r.done_at >= 0 and r.state == DONE]
        out.update({
            "tokens": self.tokens, "pt_rows": self.pt_rows,
            "restarts": self.restarts, "failed": self.failed,
            "completed": sum(1 for r in self.finished if r.state == DONE),
            "p50_ms": float(np.percentile(lat, 50) * 1e3) if lat else 0.0,
            "p99_ms": float(np.percentile(lat, 99) * 1e3) if lat else 0.0,
        })
        return out
