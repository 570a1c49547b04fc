"""The port's pack (repro_torch) against the JAX package's, on the same
numpy-seeded inputs: the plain pack == ``repro.kernels.ref`` == the Pallas
pack in interpret mode, and the channel's ``pack`` (ref and kernel impls)
== the JAX channel's, second_round included.  The CUDA kernel against its
plain version is in test_torch_gpu.py."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # collect where JAX is absent
import jax.numpy as jnp  # noqa: E402
from repro.core import channel as jch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _case(seed, r, t, w, int_payload=False, hot=0.0):
    rng = np.random.default_rng(seed)
    dst = rng.integers(-1, t, r)
    if hot:
        dst = np.where(rng.random(r) < hot, 0, dst)
    if int_payload:
        payload = rng.integers(-2 ** 31, 2 ** 31 - 1, (r, w), dtype=np.int64) \
            .astype(np.int32)
    else:
        payload = rng.normal(size=(r, w)).astype(np.float32)
    return dst.astype(np.int32), payload


@pytest.mark.parametrize("r,t,cap,int_payload", [
    (97, 8, 4, False),       # ragged R
    (64, 8, 1, False),       # capacity 1
    (200, 8, 8, True),       # int32 payload words above 2^24
    (130, 3, 50, False),     # capacity above demand
])
def test_plain_pack_matches_jax_ref_and_pallas(r, t, cap, int_payload):
    dst, payload = _case(r + cap, r, t, 5, int_payload)
    got = tref.delegation_pack(torch.as_tensor(dst), torch.as_tensor(payload),
                               t, cap)
    want_ref = jref.delegation_pack(jnp.asarray(dst), jnp.asarray(payload),
                                    t, cap)
    want_pallas = jops.delegation_pack(jnp.asarray(dst), jnp.asarray(payload),
                                       t, cap, impl="pallas")
    for want in (want_ref, want_pallas):
        for g, w, what in zip(got, want, ("slots", "counts", "request_slot")):
            assert np.array_equal(g.numpy(), np.asarray(w)), what


@pytest.mark.parametrize("r,t,c,c2", [(97, 8, 3, 5), (64, 8, 1, 1),
                                      (256, 4, 16, 0)])
def test_stacked_pack_second_round_matches_jax_rerun(r, t, c, c2):
    """The kernel's one-launch placement of both blocks equals the JAX
    channel's rerun of the pack on the rows the primary block rejected."""
    d = 3
    cases = [_case(10 * s + r, r, t, 4, int_payload=True, hot=0.5)
             for s in range(d)]
    dst = torch.as_tensor(np.stack([a for a, _ in cases]))
    words = torch.as_tensor(np.stack([b for _, b in cases]))
    s1, s2, n1, n2, req, totals = tops.delegation_pack(dst, words, t, c, c2)
    for i, (dj, pj) in enumerate(cases):
        w1, wn1, wreq1 = jref.delegation_pack(jnp.asarray(dj),
                                              jnp.asarray(pj), t, c)
        assert np.array_equal(s1[i].numpy(), np.asarray(w1))
        assert np.array_equal(n1[i].numpy(), np.asarray(wn1))
        req_want = np.asarray(wreq1)
        if c2:
            dst2 = np.where(req_want >= 0, -1, dj)
            w2, wn2, wreq2 = jref.delegation_pack(jnp.asarray(dst2),
                                                  jnp.asarray(pj), t, c2)
            assert np.array_equal(s2[i].numpy(), np.asarray(w2))
            assert np.array_equal(n2[i].numpy(), np.asarray(wn2))
            wreq2 = np.asarray(wreq2)
            req_want = np.where(wreq2 >= 0, t * c + wreq2, req_want)
        assert np.array_equal(req[i].numpy(), req_want)
        assert np.array_equal(totals[i].numpy(),
                              np.bincount(dj[dj >= 0], minlength=t))


def _payload(rng, r):
    return {"op": rng.integers(0, 4, r).astype(np.int16),
            "key": rng.integers(-2 ** 31, 2 ** 31 - 1, r,
                                dtype=np.int64).astype(np.int32),
            "value": rng.normal(size=(r, 3)).astype(np.float32),
            "ok": rng.random(r) < 0.5}


@pytest.mark.parametrize("overflow,c,c2", [("second_round", 3, 2),
                                           ("drop", 5, 0)])
@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_channel_pack_matches_jax_channel(impl, overflow, c, c2):
    """``channel.pack`` over stacked client shards == the JAX channel's
    per-shard pack, leaf by leaf (int16, int32 above 2^24, f32, bool)."""
    t, r, d = 8, 61, 2
    rng = np.random.default_rng(5)
    dsts = [rng.integers(-1, t, r).astype(np.int32) for _ in range(d)]
    pays = [_payload(rng, r) for _ in range(d)]
    cfg_t = tch.ChannelConfig(capacity=c, overflow=overflow,
                              overflow_capacity=c2, pack_impl=impl)
    stacked = {k: torch.as_tensor(np.stack([p[k] for p in pays]))
               for k in pays[0]}
    packed, gs = tch.pack(torch.as_tensor(np.stack(dsts)), stacked, t, cfg_t)
    cfg_j = jch.ChannelConfig(capacity=c, overflow=overflow,
                              overflow_capacity=c2, pack_impl="ref")
    for i in range(d):
        want, wgs = jch.pack(jnp.asarray(dsts[i]),
                             {k: jnp.asarray(v) for k, v in pays[i].items()},
                             t, cfg_j)
        assert np.array_equal(gs[i].numpy(), np.asarray(wgs))
        assert np.array_equal(packed.request_slot[i].numpy(),
                              np.asarray(want.request_slot))
        assert np.array_equal(packed.dropped[i].numpy(),
                              np.asarray(want.dropped))
        assert np.array_equal(packed.counts[i].numpy(),
                              np.asarray(want.counts))
        for k in pays[i]:
            assert np.array_equal(packed.slots[k][i].numpy(),
                                  np.asarray(want.slots[k])), k
            if c2:
                assert np.array_equal(packed.slots2[k][i].numpy(),
                                      np.asarray(want.slots2[k])), k
        if c2:
            assert np.array_equal(packed.counts2[i].numpy(),
                                  np.asarray(want.counts2))


@pytest.mark.parametrize("r", [1, 97, 2048, 4096, 5000, 50_000])
def test_pack_launch_plan_covers_each_row_once_in_order(r):
    """The count and rank kernels' chunks (``launch_plan``, shapes only)
    take each row of a shard exactly once, in row order: ragged R, R 1 and
    R a multiple of the chunk."""
    from repro_torch.kernels import delegation_pack as dp
    plan = dp.launch_plan(r, 6, 8, 8 * 8 * 20, sms=132)
    assert plan.n_chunks == -(-r // dp.CHUNK)
    rows = [i for lo, hi in dp.chunk_rows(plan, r) for i in range(lo, hi)]
    assert rows == list(range(r))
    assert all(hi > lo for lo, hi in dp.chunk_rows(plan, r))
    assert plan.rank_threads % 32 == 0 and 32 <= plan.rank_threads <= 1024


@pytest.mark.parametrize("w,aligned", [(1, True), (3, True), (6, True),
                                       (10, True), (32, True), (33, True),
                                       (64, False), (1024, True),
                                       (1024, False), (2049, True)])
@pytest.mark.parametrize("slot_rows", [0, 1, 7, 300])
def test_pack_place_walk_covers_each_slot_word_once(w, aligned, slot_rows):
    """The place kernel's grid-stride walk (a thread a word for rows under
    32 words, else a group of lanes a slot row) writes every word of every
    slot row of both blocks exactly once, with a grid set from the shapes
    alone; 16-byte copies only where W % 4 == 0 and the words are
    aligned."""
    from repro_torch.kernels import delegation_pack as dp
    plan = dp.launch_plan(4096, w, 16, slot_rows, sms=2, aligned=aligned)
    assert plan.vec == (aligned and w % 4 == 0 and w >= 32)
    if w < 32:
        assert plan.group == 0
    else:
        lanes = w // 4 if plan.vec else w
        assert plan.group in (8, 16, 32) and plan.group >= min(lanes, 32)
    assert plan.place_blocks <= 8 * 2
    assert sorted(dp.place_rows(plan, slot_rows, w)) == list(
        range(slot_rows * w))


def test_plain_pack_matches_jax_at_multi_chunk_hot_destination():
    """A shard of several of the kernels' chunks with a hot destination
    whose FIFO run crosses the chunks' edges, capacity inside a chunk:
    the plain pack == JAX's ref == the Pallas pack in interpret mode."""
    from repro_torch.kernels import delegation_pack as dp
    r, t, cap = 2 * dp.CHUNK + 901, 8, dp.CHUNK + 333
    dst, payload = _case(17, r, t, 3, int_payload=True, hot=0.6)
    got = tref.delegation_pack(torch.as_tensor(dst), torch.as_tensor(payload),
                               t, cap)
    want_ref = jref.delegation_pack(jnp.asarray(dst), jnp.asarray(payload),
                                    t, cap)
    want_pallas = jops.delegation_pack(jnp.asarray(dst), jnp.asarray(payload),
                                       t, cap, impl="pallas")
    assert int((dst == 0).sum()) > cap       # the hot run overflows
    for want in (want_ref, want_pallas):
        for g, w, what in zip(got, want, ("slots", "counts", "request_slot")):
            assert np.array_equal(g.numpy(), np.asarray(w)), what
