"""Serving driver: a request batch decoded token by token with its KV
cache entrusted to T trustees along the sequence, or a Mamba model's
(conv, ssm) state cache (the torch counterpart of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --batch 8 --prompt-len 128 --gen 128 --mesh-model 4 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-lite-16b --batch 8 --prompt-len 64 --gen 64 \\
        --mesh-model 4 [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch falcon-mamba-7b --batch 8 --prompt-len 128 --gen 128 \\
        [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen2-vl-2b --batch 4 --prompt-len 32 --gen 1 [--smoke]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-lite-16b --batch 8 --prompt-len 64 --gen 64 \\
        --mesh-data 2 --mesh-model 4 [--smoke --device cpu]

The prompt is teacher-forced through decode steps, then greedy decode
follows; every step's (k, v) write — for MLA the latent and k_rope rows
— is a delegated PUT to the owning trustee's shard and the query's
partial answers are merged (see ``models.attention.decode_attention``).
``--mesh-model T`` is the number of trustee shards stacked on the card;
the cache length is padded to a multiple of T.  ``--mesh-data N`` adds
JAX's data axis: the model runs on the (N, T) mesh, the batch split over
the N data rows when N divides it (``launch.steps.build_cell``), each
row's sequences delegating to its own T trustees; the attention and
every other layer compute a sequence on its own, so only a MoE model's
tokens can change with N (each data row sizes its own capacities).  A
MoE model's routed experts are entrusted to the same T trustees (T must
divide the expert count, else ``ValueError``), each token's rows
delegated over the channel (``models.moe``).  A Mamba layer's cache is
its (conv, ssm) state, updated in place by the plain one-step recurrence
(JAX's Mamba decode runs no kernel, so a pure-SSM serve launches none);
JAX shards the state's channels over the model axis with no channel
round, and the port keeps it whole, so ``--mesh-model`` does not change
its tokens.  Weights are
random, drawn on the device from a seeded generator; the prompts come
from ``np.random.default_rng(0)`` as in JAX, so both packages see the
same tokens.  Runs on ``cuda`` unless given ``--device cpu``.  The
decode step is ``build_cell``'s captured program (a CUDA graph replayed
each step, the positions and tokens copied into its buffers, each next
token a fresh tensor; ``core.compiled.disable()`` runs it eagerly);
``stats["issue_ms_per_step"]`` is the host's time to return from a step
(the median after the first), with no synchronize.

An embeds-input model (qwen2-vl-2b, the vision frontend a stub) is
prompted with bf16 embeddings drawn as JAX draws them, ``rng.normal(
size=(prompt_len, batch, d_model)) * 0.02``; JAX's loop then feeds the
generated token's id where the decode step takes a (B, D) embedding, so
it defines the prompt and the one token generated from its last
position and nothing after: ``--gen > 1`` raises
``NotImplementedError`` (the port invents no text-embedding path).  The
encoder-decoder model (seamless-m4t-large-v2) decodes text: a token
prompt, against a cross-attention cache that, as in JAX, stays zeros
(nothing runs the encoder in the serve).

The store-level bookkeeping of the paper's §7 lives on the whole
(mesh_data, mesh_model) ``StackedMesh`` on the serve's device, as in
JAX: a ledger of generated tokens per request (a ``DelegatedKVStore``),
one ADD a generated token.  It runs
with ``--session``, ``--delegation-mode dedicated`` or ``--drain-rounds >
1``.  ``--session`` adds a traffic meter per device bucket whose ADDs
ride ONE multiplexed ``session.step()`` with the ledger's; with
``--stream-depth N`` a ``StreamingDriver`` keeps up to N of those rounds
in flight behind the decode loop, under an ``AdmissionControl``.
``--delegation-mode dedicated`` puts the ledger and meter on the last
``--n-dedicated`` shards of the mesh (default half of all of them),
serving the others; the model's own channels (the KV cache, the
experts) stay shared.  ``--drain-rounds N`` gives them a one-row primary
block with the defer drain of up to N rounds, and prints the ledger's
drain stats.  ``--serve-impl`` picks the
stores' serve: "pallas" the CUDA serve kernels, "ref" their plain
versions, "masked" the per-op reference.  ``--chaos WAVE`` (with
``--session``) tears the ledger and meter's session round at engine wave
WAVE — the round runs, its results are lost before any state commits —
and recovers: the last snapshot (one every ``--chaos-snap-every`` waves,
at quiesce points) is restored, the waves since it are replayed inside
``session.replaying()`` and the torn wave is retried; the run fails with
``SystemExit`` unless the ledger then counts ``--gen`` tokens a request.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None,
                    help="architecture id (required unless an in-process "
                         "caller passes cfg=)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data rows of the mesh: the batch split over "
                         "them, stacked on the card")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="trustee shards of the KV cache's sequence axis, "
                         "stacked on the card")
    ap.add_argument("--delegation-mode", default="shared",
                    choices=["shared", "dedicated"])
    ap.add_argument("--n-dedicated", type=int, default=0)
    ap.add_argument("--drain-rounds", type=int, default=1)
    ap.add_argument("--serve-impl", default="ref",
                    choices=["ref", "pallas", "masked"],
                    help="serve path of the --session stores: the CUDA "
                         "serve kernels (pallas), their plain versions "
                         "(ref) or the per-op reference (masked)")
    ap.add_argument("--session", action="store_true")
    ap.add_argument("--stream-depth", type=int, default=0)
    ap.add_argument("--chaos", type=int, default=None, metavar="WAVE")
    ap.add_argument("--chaos-snap-every", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def main(argv=None, stats: Optional[dict] = None, *,
         cfg=None) -> np.ndarray:
    """Run the serve loop; returns the generated tokens (batch, gen): the
    greedy token after each position from the last prompt position on, as
    JAX's loop collects them.  ``cfg``, a ``ModelConfig``, takes the
    place of ``--arch``'s (and ``--smoke``'s): an in-process caller
    serves a registered architecture at a reduced depth with it,
    ``cfg=get_arch(name).with_overrides(n_layers=...)``, as JAX's
    trainer takes ``--n-layers``.  Before any weight is drawn on the
    card, the weights' and the cache's bytes (from their shapes) are held
    against its free memory: a depth the card cannot hold raises
    ``ValueError`` naming the bytes and the largest depth that fits.
    ``stats``, when given, receives
    the loop's steps, seconds, ms per step and tokens/s; with a ledger
    (``--session``, ``--delegation-mode dedicated`` or ``--drain-rounds >
    1``) the ledger, its ``client_region()`` and its drain stats (None
    without ``--drain-rounds``); with ``--session`` also the meter, the
    last wave's ``last_step_info``, the fused waves'
    ``last_step_info["fused"]`` (one entry a round) and ``recovery``
    (``last_stats()["recovery"]``, None without a recovery); in dedicated
    mode ``partition``, the (client, trustee) shard slots of the mesh."""
    ap = _parser()
    args = ap.parse_args(argv)
    if cfg is None and args.arch is None:
        ap.error("--arch is required")
    if cfg is not None and (args.arch is not None or args.smoke):
        ap.error("cfg= takes the place of --arch and --smoke")
    if args.stream_depth > 0 and not args.session:
        ap.error("--stream-depth requires --session")
    if args.chaos is not None and not args.session:
        ap.error("--chaos requires --session (it tears a session engine "
                 "round)")
    if args.mesh_data < 1 or args.mesh_model < 1:
        ap.error("--mesh-data and --mesh-model must be >= 1")
    if args.delegation_mode == "dedicated" \
            and args.mesh_data * args.mesh_model < 2:
        ap.error("--delegation-mode dedicated needs a mesh with >= 2 "
                 "shards (reserve trustee shards with --mesh-data / "
                 "--mesh-model)")

    from ..core import meshctx
    prev_mode = meshctx.delegation_mode()
    try:
        with meshctx.kept_context():
            return _serve(args, stats, cfg)
    finally:
        meshctx.set_delegation_mode(*prev_mode)


def _free_bytes(dev: torch.device) -> Optional[int]:
    """The card's free memory (``torch.cuda.mem_get_info``); None off the
    card, where nothing is refused."""
    if dev.type != "cuda":
        return None
    return torch.cuda.mem_get_info(dev)[0]


def check_fits(cfg, run, batch: int, max_len: int,
               dev: torch.device) -> None:
    """Refuse, before anything is allocated, a depth whose weights and
    decode cache (bytes from their shapes: ``model.param_nbytes``,
    ``cache_nbytes``) exceed the card's free memory: ``ValueError``
    naming the bytes and the largest depth that fits, in whole groups of
    the architecture's repeating pattern (``transformer.layer_descs``)."""
    from ..models import model as M
    from ..models.transformer import layer_descs
    free = _free_bytes(dev)
    if free is None:
        return

    def need(c):
        r = dataclasses.replace(run, model=c)
        return M.param_nbytes(c, r) + M.cache_nbytes(c, batch, max_len, r)
    total = need(cfg)
    if total <= free:
        return
    if M.is_encdec(cfg):
        prefix, group, n_groups = 0, 1, cfg.n_layers
    else:
        descs, prefix, n_groups = layer_descs(cfg)
        group = len(descs)
    fit = None
    for k in range(n_groups - 1, 0, -1):
        c = cfg.with_overrides(n_layers=prefix + k * group)
        if need(c) <= free:
            fit = (c.n_layers, k, need(c))
            break
    if fit is None:
        hint = "not even one layer fits"
    else:
        depth = f"{fit[0]} layer{'s' if fit[0] > 1 else ''}" + (
            f" ({fit[1]} of {n_groups} groups)" if group > 1 else "")
        hint = (f"the largest depth that fits is {depth}, {fit[2] / 1e9:.2f} "
                f"GB: serve it in process with serve.main(..., cfg=get_arch"
                f"({cfg.name!r}).with_overrides(n_layers={fit[0]}))")
    raise ValueError(
        f"{cfg.name} at {cfg.n_layers} layers does not fit the card: its "
        f"weights and decode cache take {total / 1e9:.2f} GB "
        f"({M.param_nbytes(cfg, run) / 1e9:.2f} GB of weights) and "
        f"{free / 1e9:.2f} GB are free; {hint}")


def _serve(args, stats: Optional[dict], cfg=None) -> np.ndarray:
    from ..configs.base import MeshConfig, RunConfig, ShapeConfig
    from ..configs.registry import get_arch, get_smoke_arch
    from ..core import meshctx
    from ..core.meshctx import resolve_device
    from ..core.routing import (default_n_dedicated,
                                partition_clients_trustees)
    from ..models import model as M
    from .mesh import make_local_mesh
    from .steps import build_cell

    dev = resolve_device(args.device)
    mesh = make_local_mesh(args.mesh_data, args.mesh_model, device=dev)
    if args.delegation_mode == "dedicated":
        n_ded = args.n_dedicated or default_n_dedicated(mesh.size)
        clients, trustees = partition_clients_trustees(mesh.size, n_ded)
        meshctx.set_delegation_mode("dedicated", n_ded)
        if stats is not None:
            stats["partition"] = (clients, trustees)
        print(f"[serve] delegation mode: dedicated — client shards "
              f"{clients.tolist()}, trustee shards {trustees.tolist()} "
              f"(the store-level delegation — the ledger below and any "
              f"local_trustees() group — runs dedicated; the model's own "
              f"channels stay shared)", flush=True)
    else:
        meshctx.set_delegation_mode("shared", 0)

    if cfg is None:
        cfg = get_smoke_arch(args.arch) if args.smoke \
            else get_arch(args.arch)
    embeds = cfg.input_mode == "embeds" and not M.is_encdec(cfg)
    if embeds and args.gen > 1:
        raise NotImplementedError(
            f"--gen {args.gen} for {cfg.name}, an embeds-input model: JAX's "
            f"serve loop feeds a generated token's id where the decode step "
            f"takes a (B, D) embedding, so it defines only the first "
            f"generated token (--gen 1), and the port invents no "
            f"text-embedding path (ROADMAP, reference side)")
    t = args.mesh_model
    max_len = args.prompt_len + args.gen
    max_len = ((max_len + t - 1) // t) * t      # a whole shard per trustee
    shape = ShapeConfig("cli", max_len, args.batch, "decode")
    # use_pallas: the hand-written kernels wherever the decode step has
    # one (the MoE's grouped matmul; the decode attention is the plain
    # trustee island and the Mamba step the plain recurrence, as in JAX)
    # — their plain versions on CPU tensors
    run = RunConfig(model=cfg, shape=shape,
                    mesh=MeshConfig((args.mesh_data, t), ("data", "model")),
                    remat="none", use_pallas=True)
    check_fits(cfg, run, args.batch, max_len, dev)
    plan = build_cell(cfg, shape, run, mesh)
    params = M.init_params(cfg, run, dev)
    cache = M.init_cache(cfg, args.batch, max_len, run, dev)
    n_params = M.count_params(params)
    if cfg.is_attention_free:
        cache_kind = "the Mamba (conv, ssm) state, whole"
    elif cfg.block_pattern:
        cache_kind = (f"the attention layers' KV over {t} trustee shards "
                      f"beside the Mamba layers' (conv, ssm) state, whole")
    else:
        cache_kind = f"{t} trustee shards"
    if args.mesh_data > 1:
        cache_kind += (f", {args.mesh_data} data rows"
                       if args.batch % args.mesh_data == 0 else
                       f", the batch replicated over {args.mesh_data} "
                       f"data rows")
    if M.is_encdec(cfg):
        cache_kind += " (self) and a zero cross cache"
    print(f"[serve] {cfg.name}: {n_params/1e6:.2f}M params "
          f"({M.active_param_count(cfg, n_params)/1e6:.2f}M active a token), "
          f"cache len {max_len}, batch {args.batch}, {cache_kind} on "
          f"{dev}", flush=True)

    # "prefill" by teacher-forcing the prompt through decode steps (one
    # code path, as in JAX)
    rng = np.random.default_rng(0)
    if embeds:
        # JAX's bf16 prompt of embeddings, (prompt_len, batch, d_model)
        prompt = torch.as_tensor(
            rng.normal(size=(args.prompt_len, args.batch, cfg.d_model))
            * 0.02).to(device=dev, dtype=torch.bfloat16)
    else:
        prompt_ids = rng.integers(0, cfg.vocab_size,
                                  size=(args.prompt_len, args.batch))
        prompt = torch.as_tensor(prompt_ids, dtype=torch.int32, device=dev)
    book = _Bookkeeping(args, mesh) if (
        args.session or args.delegation_mode == "dedicated"
        or args.drain_rounds > 1) else None
    steps = args.prompt_len + args.gen - 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    prev, outputs, issue = None, [], []
    for i in range(steps):
        tok = prompt[i] if i < args.prompt_len else prev
        pos = torch.full((args.batch,), i, dtype=torch.int32, device=dev)
        t1 = time.perf_counter()
        prev, cache = plan.step_fn(params, cache, tok, pos)
        issue.append(time.perf_counter() - t1)
        if i >= args.prompt_len - 1:
            outputs.append(prev)
            if book is not None:
                book.wave()
    if book is not None:
        book.finish()
    gen = torch.stack(outputs, 1).cpu().numpy()      # ends in a host sync
    dt = time.perf_counter() - t0
    if book is not None:
        book.report(stats)
    print(f"[serve] {steps} steps in {dt:.2f}s ({1e3 * dt / steps:.1f} "
          f"ms/step, {args.batch * steps / dt:.0f} tok/s)", flush=True)
    print(f"[serve] generated {gen.shape} tokens; sample: {gen[0][:10]}",
          flush=True)
    if stats is not None:
        # the host's time to return from a decode step (no synchronize):
        # the median over the steps after the first (which captures)
        later = sorted(issue[1:]) or issue
        stats.update(steps=steps, seconds=dt, ms_per_step=1e3 * dt / steps,
                     tokens_per_s=args.batch * steps / dt,
                     params=M.count_params(params),
                     issue_ms_per_step=1e3 * later[len(later) // 2])
    return gen


class _Bookkeeping:
    """The store-level bookkeeping: per-request generated-token counters
    (``ledger``) and, with ``--session``, per-device-bucket traffic
    (``meter``) with the ledger's channel signature, so each generated
    token's ADDs to both ride ONE multiplexed engine round.  Both take the
    session-wide delegation mode; ``--drain-rounds N`` gives them a
    one-row primary block drained over up to N rounds."""

    def __init__(self, args, mesh):
        from ..core import DelegatedKVStore, TrustSession
        from ..core.meshctx import delegation_mode
        from .streaming import AdmissionControl, StreamingDriver
        dev = mesh.device
        self.mode, n_ded = delegation_mode()
        self.drain_rounds = args.drain_rounds
        self.session = TrustSession()
        impl = "kernel" if args.serve_impl == "pallas" else args.serve_impl
        if args.drain_rounds > 1:
            # a one-row primary block: the increments trickle through the
            # defer drain's retry rounds (the paper's §5.1 wait)
            kw = dict(capacity=1, overflow="defer",
                      max_rounds=args.drain_rounds)
        else:
            kw = dict(capacity=max(4, args.batch))
        kw.update(serve_impl=impl, session=self.session, mode=self.mode,
                  n_dedicated=n_ded)
        self.ledger = DelegatedKVStore(mesh, args.batch, 1, name="ledger",
                                       **kw)
        self.meter = DelegatedKVStore(mesh, mesh.size, 1, name="meter",
                                      **kw) if args.session else None
        self.keys = torch.arange(args.batch, dtype=torch.int32, device=dev)
        self.meter_keys = self.keys % mesh.size
        self.ones = torch.ones((args.batch, 1), device=dev)
        self.fused = []
        self.driver = self.wave_rows = None
        if args.stream_depth > 0:
            # dispatch-ahead: token t's round runs behind token t+1's
            # decode step; admission bounds the ledger rows in flight
            self.wave_rows = args.batch + mesh.size
            self.driver = StreamingDriver(
                self.session, depth=args.stream_depth,
                admission=AdmissionControl(
                    self.wave_rows * (args.stream_depth + 1)))
        self.gen = args.gen
        self.chaos_dir = None
        if args.chaos is not None:
            # tear the session round at wave args.chaos (it runs, its
            # results are lost before any state commits); recover from the
            # snapshot taken every args.chaos_snap_every waves
            import tempfile
            from ..runtime import EngineFailureInjector
            self.chaos_dir = tempfile.mkdtemp(prefix="serve_chaos_")
            self.snap_every = args.chaos_snap_every
            self.since_snap = 0
            self.session.install_injector(EngineFailureInjector(
                schedule={args.chaos: ("tear", 0)}))
            print(f"[serve] chaos: tearing session wave {args.chaos}, "
                  f"snapshots every {self.snap_every} waves", flush=True)
            self._snapshot()

    def _snapshot(self):
        if self.driver is not None:
            self.driver.checkpoint(self.chaos_dir)
        else:
            self.session.checkpoint(self.chaos_dir)

    def _session_wave(self):
        """One generated token's ADDs to the ledger and the meter, in ONE
        fused session round."""
        self.ledger.trust.op.add.then(self.keys, self.ones)
        self.meter.trust.op.add.then(self.meter_keys, self.ones)
        if self.driver is not None:
            self.driver.admit(self.wave_rows)
            self.driver.dispatch(rows=self.wave_rows)
        else:
            self.session.step()
        self.fused.append(self.session.last_step_info["fused"])

    def wave(self):
        if self.meter is None:
            self.ledger.trust.op.add(self.keys, self.ones)
            return
        if self.chaos_dir is None:
            self._session_wave()
            return
        from ..runtime import TrusteeFailure
        try:
            self._session_wave()
        except TrusteeFailure as e:
            print(f"[serve] chaos: {e}", flush=True)
            if self.driver is not None:
                self.driver.recover(e, self.chaos_dir)
            else:
                self.session.restore(self.chaos_dir)
            # replay the acknowledged waves since the snapshot, then retry
            # the torn one (the restore dropped its queued batches)
            with self.session.replaying():
                for _ in range(self.since_snap):
                    self._session_wave()
            self._session_wave()
        self.since_snap += 1
        if self.since_snap % self.snap_every == 0:
            self._snapshot()
            self.since_snap = 0

    def finish(self):
        if self.driver is not None:
            self.driver.drain()

    def report(self, stats: Optional[dict]):
        ledger = self.ledger.dump()[:, 0].astype(int)
        print(f"[serve] ledger ({self.mode}): generated tokens per request "
              f"= {ledger.tolist()}", flush=True)
        drain = None
        if self.drain_rounds > 1:
            drain = self.ledger.trust.last_drain_stats()
            print(f"[serve] ledger drain: {drain['rounds']} round(s) in the "
                  f"last step, residual {drain['residual']} (bound "
                  f"{self.drain_rounds})", flush=True)
        if stats is not None:
            stats.update(ledger=ledger, drain=drain,
                         client_region=self.ledger.client_region())
        if self.meter is None:
            return
        meter = self.meter.dump()[:, 0].astype(int)
        info = self.session.last_step_info
        print(f"[serve] meter: tokens per device bucket = {meter.tolist()}",
              flush=True)
        print(f"[serve] session engine (last wave): "
              f"{info['fused'] or 'solo rounds'} — per-trust stats "
              f"{self.session.last_stats()}", flush=True)
        if self.driver is not None:
            print(f"[serve] streaming driver: {self.driver.stats()}",
                  flush=True)
        rec = self.session.last_stats().get("recovery")
        if stats is not None:
            stats.update(meter=meter, step_info=info,
                         fused_waves=self.fused, recovery=rec)
        if self.chaos_dir is not None:
            import shutil
            shutil.rmtree(self.chaos_dir, ignore_errors=True)
            ok = bool(np.all(ledger == self.gen))
            print(f"[serve] chaos recovery: {rec} — ledger counts "
                  f"{'MATCH' if ok else 'DIVERGE FROM'} the {self.gen} "
                  f"generated tokens per request", flush=True)
            if not ok:
                raise SystemExit("[serve] chaos recovery diverged")


if __name__ == "__main__":
    main()
