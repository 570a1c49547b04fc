"""End to end: the port's paged decode (``launch.paged_decode.run_decode``:
``PagedDecodeDriver`` over a ``DelegatedPageTable`` on 8 stacked shards,
one ``paged_decode_attention`` layer) against the JAX example's
(``examples/paged_decode.py::run_decode`` on 8 virtual CPU devices), on the
example's geometry (64 pages, 16 sequences, 4-token pages, 8-page chains,
capacity 128), the same requests, the same token stream and the same
weights (JAX's, carried through ``convert``), at driver depth 0 and 2:

  * every wave's page-table responses (page assignments, counts, flags),
    bit for bit, and the final page-table state;
  * tokens, restarts, failures and the conservation audit;
  * every decode step's attention-layer output, within 2e-5 (f32 sums in
    another order by another library).

The example's page-pressure admission keeps every chain inside its
owner's pool, so those runs evict nothing.  A third run makes the driver
heal: a client outside the driver allocates a chain on a sequence id the
driver never uses (``HOG``) in one early wave, which evicts a decoding
sequence on the same trustee; its next append re-allocates the chain and
the driver replays its prompt (a restart) — the heal-and-replay
bookkeeping of ``PagedDecodeDriver._on_wave``, held to the JAX driver's.
The JAX side runs in one subprocess: this module, run as a script (it
reproduces the example's ``run_decode`` with recording hooks, the example
itself unchanged).
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import subprocess

import numpy as np
import pytest

DEPTHS = (0, 2)
N_REQUESTS, SEED = 16, 0
# the healing run: 10 requests use sequence ids 0-9 only; at the dispatch
# of wave 5 an outside client allocates 6 pages for sequence 15 (trustee 7)
HOG = dict(n_requests=10, wave=5, seq=15, pages=6)
GEOM = dict(n_pages=64, max_seqs=16, page_size=4, max_pages=8, capacity=128)
FIELDS = ("pages", "page", "n", "flag")
OPS = ("alloc", "append", "free", "lookup")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_paged") / "runs.npz"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([src,
                                          os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def hogging(driver_cls):
    """``driver_cls.step_wave`` that first submits the outside client's
    alloc at the dispatch of wave ``HOG["wave"]`` (once)."""
    step_wave = driver_cls.step_wave

    def wrapped(self):
        if self._next_wave == HOG["wave"] and not getattr(self, "_hogged",
                                                          False):
            self._hogged = True
            self.pagetable.alloc_then(np.array([HOG["seq"]], np.int32),
                                      np.array([HOG["pages"]], np.int32))
        return step_wave(self)
    return wrapped


@pytest.mark.parametrize("tag", [f"d{d}" for d in DEPTHS] + ["hog"])
def test_port_decode_matches_jax_example(jax_runs, tag, monkeypatch):
    from repro_torch import convert
    from repro_torch.launch.paged_decode import run_decode
    from repro_torch.launch.paged_serve import PagedDecodeDriver
    params = {k[len("params/"):]: v for k, v in jax_runs.items()
              if k.startswith("params/")}
    n_req, depth = (HOG["n_requests"], 2) if tag == "hog" \
        else (N_REQUESTS, int(tag[1:]))
    if tag == "hog":
        monkeypatch.setattr(PagedDecodeDriver, "step_wave",
                            hogging(PagedDecodeDriver))
    stats = run_decode(n_requests=n_req, depth=depth, seed=SEED,
                       device="cpu", record=True, check=True,
                       params=convert.attention_params_from_jax(
                           params, device="cpu"), **GEOM)
    for k in ("tokens", "restarts", "failed", "completed", "pt_rows",
              "kv_writes"):
        assert stats[k] == int(jax_runs[f"{tag}/{k}"]), k
    assert stats["completed"] == n_req and stats["failed"] == 0
    assert (stats["restarts"] > 0) == (tag == "hog")
    a = stats["audit"]
    assert a["consistent"] and a["leaked"] == 0 and a["allocated"] == 0
    assert a["evictions"] == int(jax_runs[f"{tag}/evictions"])
    waves = stats["pt_responses"]
    assert len(waves) == int(jax_runs[f"{tag}/n_waves"])
    for i, wave in enumerate(waves):
        ops = [OPS.index(op) for op, _ in wave]
        assert ops == list(jax_runs[f"{tag}/{i}/ops"]), f"wave {i}"
        for j, (op, r) in enumerate(wave):
            for f in FIELDS:
                assert np.array_equal(r[f], jax_runs[f"{tag}/{i}/{j}/{f}"]), \
                    f"wave {i} {op} {f}"
    for k, v in stats["dump"].items():
        assert np.array_equal(v, jax_runs[f"{tag}/final/{k}"]), k
    ys = stats["ys"]
    assert len(ys) == int(jax_runs[f"{tag}/n_ys"])
    for i, y in enumerate(ys):
        np.testing.assert_allclose(y, jax_runs[f"{tag}/y/{i}"], rtol=2e-5,
                                   atol=2e-5)
    chk = stats["check"]
    assert chk["attention_out_of_tolerance"] == 0
    # every row the page table served, the outside client's one included
    assert chk["rows_replayed"] == stats["pt_rows"] + (tag == "hog")


def _jax_run(depth, res, tag, n_requests, hog=False):
    """``examples/paged_decode.py::run_decode`` with its defaults (but
    ``n_requests`` requests and the driver ``depth``, and with ``hog`` the
    outside client's alloc), recording every wave's page-table responses
    and every decode step's output."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.base import ModelConfig
    from repro.core import DelegatedPageTable, TrustSession, use_session
    from repro.launch.paged_serve import DecodeRequest, PagedDecodeDriver
    from repro.launch.streaming import AdmissionControl
    from repro.models import attention as att
    mesh = Mesh(np.array(jax.devices()).reshape(1, -1), ("data", "model"))
    cfg = ModelConfig(name="paged-demo", family="dense", n_layers=1,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab_size=256)
    g = GEOM
    ps, mp, max_seqs = g["page_size"], g["max_pages"], g["max_seqs"]
    rng = np.random.default_rng(SEED)
    params = att.init_attention(jax.random.PRNGKey(SEED), cfg, jnp.float32)
    for k, v in params.items():
        res[f"params/{k}"] = np.asarray(v)
    pool = att.init_paged_kv_pool(cfg, g["n_pages"], ps, jnp.float32)
    with use_session(TrustSession()):
        pt = DelegatedPageTable(mesh, g["n_pages"], max_seqs=max_seqs,
                                page_size=ps, max_pages=mp,
                                capacity=g["capacity"])
        max_total = mp * ps
        xs = jnp.asarray(rng.normal(size=(max_seqs, max_total,
                                          cfg.d_model)), jnp.float32)
        state = {"pool": pool, "ys": [], "kv_writes": 0}
        step = jax.jit(lambda x, pos, pool, tbl: att.paged_decode_attention(
            params, x, pos, pool, tbl, cfg))

        def write_kv(seqs, positions, chains):
            x = xs[jnp.asarray(seqs), jnp.asarray(positions)]
            y, state["pool"] = step(x, jnp.asarray(positions, jnp.int32),
                                    state["pool"],
                                    jnp.asarray(chains, jnp.int32))
            state["kv_writes"] += len(seqs)
            return y

        def on_prefill(seqs, lengths, chains):
            for t in range(int(np.max(lengths))):
                live = lengths > t
                if not live.any():
                    break
                write_kv(seqs[live], np.full(int(live.sum()), t, np.int32),
                         chains[live])

        def on_decode(seqs, positions, chains):
            state["ys"].append(np.asarray(write_kv(seqs, positions, chains)))

        log, waves = [], []
        for op in OPS:
            fn = getattr(pt, op + "_then")

            def rec(seqs, *args, _fn=fn, _op=op, then=None):
                fut = _fn(seqs, *args, then=then)
                log.append((_op, np.asarray(seqs), fut))
                return fut
            setattr(pt, op + "_then", rec)

        class Driver(PagedDecodeDriver):
            def dispatch(self, *args, **kw):
                waves.append(list(log))
                log.clear()
                return super().dispatch(*args, **kw)

        if hog:
            Driver.step_wave = hogging(Driver)

        drv = Driver(pt, depth=depth,
                     admission=AdmissionControl(512, per_user_rows=256),
                     on_prefill=on_prefill, on_decode=on_decode,
                     max_active=max_seqs)
        reqs = [DecodeRequest(rid=i,
                              prompt_len=int(rng.integers(2, max_total // 2)),
                              gen_len=int(rng.integers(4, max_total // 2)),
                              user=f"u{i % 4}")
                for i in range(n_requests)]
        stats = drv.run(reqs)
        for k in ("tokens", "restarts", "failed", "completed", "pt_rows"):
            res[f"{tag}/{k}"] = stats[k]
        res[f"{tag}/kv_writes"] = state["kv_writes"]
        res[f"{tag}/evictions"] = pt.audit()["evictions"]
        res[f"{tag}/n_waves"] = len(waves)
        for i, wave in enumerate(waves):
            res[f"{tag}/{i}/ops"] = np.array([OPS.index(op)
                                              for op, _, _ in wave])
            for j, (op, seqs, fut) in enumerate(wave):
                r = pt.globalize(fut.result(), seqs)
                for f in FIELDS:
                    res[f"{tag}/{i}/{j}/{f}"] = r[f]
        for k, v in pt.dump().items():
            res[f"{tag}/final/{k}"] = v
        res[f"{tag}/n_ys"] = len(state["ys"])
        for i, y in enumerate(state["ys"]):
            res[f"{tag}/y/{i}"] = y


def _jax_main(out_path):
    res = {}
    for depth in DEPTHS:
        _jax_run(depth, res, f"d{depth}", N_REQUESTS)
    _jax_run(2, res, "hog", HOG["n_requests"], hog=True)
    np.savez(out_path, **res)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
