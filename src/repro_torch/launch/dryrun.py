"""Dry run: build and count every (arch x input-shape x mesh) cell on the
meta device (the torch counterpart of ``repro.launch.dryrun``).

JAX's dry run lowers and compiles each production cell on 512 fake
devices: the compile proves the cell builds at its published shape, and
XLA's cost and memory analyses give its compute, memory and collective
terms.  Here the cell is built on a ``StackedMesh`` of the production
shape on the meta device, which holds shapes and dtypes and no data, and
one step runs there (prefill and decode with ``use_pallas=True``, as the
serve runs them, so every kernel wrapper's checks pass on the cell's
shapes; train on the plain path, as the trainer runs it) under
``CountingMode``, a dispatch mode that gathers:

  * FLOPs, by ``torch.utils.flop_counter``'s formulas;
  * the bytes each non-view aten op reads and writes;
  * the channel's block transposes (the all_to_alls) and their bytes;
  * the peak of live bytes made during the step, each storage counted
    once (views share storage);
  * the kernels' work, from the wrappers' meta branches
    (``rooflines.counting_kernels``).

Nothing is allocated and nothing runs on the card: the module never
touches a CUDA device, by design, as JAX's dry run never touches a TPU.

Protocol per cell (JAX's): a full-depth pass (the build, and memory:
``argument_size_in_bytes`` the parameters, AdamW moments, decode cache
and batch; ``temp_size_in_bytes`` the peak), then — on the single-pod
mesh — 1-group and 2-group probes of the repeating layer pattern,
extrapolated linearly: body = c2 - c1, base = c1 - body, total = base +
n_groups * body.  An eager count sees every layer, so the extrapolation
equals the full pass's count; the probes keep the cell's ``grad_accum``
(JAX's run at 1 to save compile time; here the weights' reads scale with
the microbatches).  ``--mesh multi`` skips the probes, as JAX's does.

Results are cached as JSON per cell under ``ARTIFACT_DIR`` (ignored by
git), so an interrupted sweep resumes.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --render --mesh both   # the table
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

ARTIFACT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "..", "..", "artifacts", "dryrun")

# per-arch run overrides for the production cells (JAX's)
RUN_OVERRIDES = {
    # 480B: bf16 moments, bf16 grad accumulation, deeper microbatching.
    # JAX's "fsdp_inference" (weights sharded over the data axis at serve
    # time) is a GSPMD layout with no field on one card, so it is dropped.
    "arctic-480b": {"opt_dtype": "bfloat16", "grad_accum": 8,
                    "grad_accum_dtype": "bfloat16"},
}
TRAIN_REMAT = "full"      # production default at this scale

_COST_KEYS = ("flops", "bytes accessed", "transcendentals")
# the port's one collective: the channel's block transpose, JAX's
# all_to_all
_COLL_KINDS = ("all-to-all",)
_TRANSCENDENTAL = {    # and their in-place forms (a trailing "_")
    "exp", "exp2", "expm1", "log", "log1p", "log2", "sigmoid",
    "tanh", "sin", "cos", "rsqrt", "sqrt", "softplus", "silu", "gelu",
    "erf", "_softmax", "_log_softmax", "pow"}
# aten ops that only describe a tensor, not move it
_METADATA = {"_unsafe_view", "lift_fresh", "_reshape_alias", "alias",
             "detach", "set_"}
_ALLOCATE_ONLY = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided"}
# in-place ops whose written argument is not read
_OVERWRITE = {"copy_", "zero_", "fill_", "normal_", "uniform_"}


def _tensors(x, out):
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CountingMode(TorchDispatchMode):
    """Counts a step's work op by op: ``flops`` (``flop_counter``'s
    formulas), ``nbytes`` read and written by every aten op that is not a
    view or a bare allocation, ``transcendentals`` (the outputs of exp,
    log, sigmoid, ...), the ``devices`` of every tensor seen (and in
    ``off_meta`` the ops that saw one off the meta device, with its
    device), and ``peak`` — the largest sum of live storages made inside
    the mode, each counted once, freed when its last user is."""

    def __init__(self, preexisting=()):
        super().__init__()
        self.flops = 0
        self.nbytes = 0
        self.transcendentals = 0
        self.ops = 0
        self.devices = set()
        self.off_meta = {}
        self.live = 0
        self.peak = 0
        self._tracked = {}
        self._pre = {t.untyped_storage()._cdata for t in preexisting}

    def _free(self, key, n):
        if self._tracked.pop(key, None) is not None:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        ins = _tensors(args, _tensors(kwargs, []))
        outs = _tensors(out, [])
        for t in ins + outs:
            self.devices.add(t.device.type)
            if t.device.type != "meta":
                self.off_meta.setdefault(str(func), []).append(
                    f"{t.device.type} {tuple(t.shape)}")
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        name = packet.__name__
        schema = func._schema
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)
        if view or name in _METADATA:
            return out
        if name.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if name in _ALLOCATE_ONLY:
            written = 0
        else:
            written = sum(_nbytes(t) for t in outs)
        read = 0
        for i, a in enumerate(schema.arguments):
            v = kwargs.get(a.name) if a.kwarg_only or i >= len(args) \
                else args[i]
            if not isinstance(v, (torch.Tensor, list, tuple)):
                continue
            is_write = a.alias_info is not None and a.alias_info.is_write
            if is_write and (name in _OVERWRITE or a.kwarg_only):
                continue            # written, not read (copy_, out=)
            read += sum(_nbytes(t) for t in _tensors(v, []))
        self.nbytes += read + written
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._tracked or key in self._pre:
                continue
            n = st.nbytes()
            self._tracked[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


def cell_runnable(cfg, shape) -> (bool, str):
    if shape.name == "long_500k" and not cfg.has_subquadratic_context:
        return False, ("skipped: pure full-attention arch; 500k decode "
                       "requires sub-quadratic context (DESIGN.md §4)")
    return True, ""


def cell_path(arch: str, shape: str, mesh: str, tag: str = "",
              art_dir: Optional[str] = None) -> str:
    art_dir = ARTIFACT_DIR if art_dir is None else art_dir
    os.makedirs(art_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(art_dir,
                        f"{arch}__{shape}__{mesh}{suffix}.json".replace("/", "_"))


def _reduced(cfg, groups: int):
    """Config with n_groups == groups (prefix preserved)."""
    from ..models.transformer import layer_descs
    if cfg.is_encoder_decoder:
        return cfg.with_overrides(n_layers=groups, n_encoder_layers=groups)
    descs, prefix_len, n_groups = layer_descs(cfg)
    return cfg.with_overrides(n_layers=prefix_len + groups * len(descs))


def _n_groups(cfg) -> int:
    from ..models.transformer import layer_descs
    if cfg.is_encoder_decoder:
        return cfg.n_layers
    return layer_descs(cfg)[2]


def _lin(base, body, n):
    return {k: base[k] + n * body[k] for k in base}


def _tree_nbytes(tree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree, []))


def cell_arguments(plan, device="meta"):
    """The step's arguments on ``device``, as the step takes them:
    (params, opt_state, batch) for train, (params, batch) for prefill,
    (params, cache, tokens, pos) for decode."""
    from ..models import model as M
    from ..models.layers import dtype_of
    from ..optim.optimizer import init_adamw
    cfg, shape, run = plan.cfg, plan.shape, plan.run
    params = M.init_params(cfg, run, device)
    batch = {k: torch.empty(s, dtype=d, device=device)
             for k, (s, d) in M.input_specs(cfg, shape, run).items()}
    if shape.kind == "train":
        return (params, init_adamw(params, dtype_of(run.opt_dtype)), batch)
    if shape.kind == "prefill":
        return (params, batch)
    cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, run,
                         device)
    return (params, cache, batch["tokens"], batch["pos"])


def _measure(plan) -> dict:
    """Run one step of ``plan`` on meta arguments under the counting
    modes: its ``cost`` and ``collectives`` (JAX's keys), ``memory``,
    ``n_params``, ``count_s``, the ``devices`` seen (and the ops that saw
    a tensor off the meta device, ``off_meta``) and the ``kernels``'
    tally."""
    from ..core.channel import collect_transpose_bytes
    from ..models import model as M
    from . import rooflines
    t0 = time.monotonic()
    args = cell_arguments(plan)
    mode = CountingMode(_tensors(args, []))
    with rooflines.counting_kernels() as tally, \
            collect_transpose_bytes() as moves:
        with mode:
            out = plan.step_fn(*args)
        del out
    res = dict(
        count_s=time.monotonic() - t0,
        cost={"flops": float(mode.flops + tally.total("ops")),
              "bytes accessed": float(mode.nbytes + tally.total("bytes")),
              "transcendentals": float(mode.transcendentals
                                       + tally.total("exps"))},
        # a transpose reads the stacked tensor once and writes it once
        collectives={"all-to-all": {
            "count": len(moves),
            "bytes": float(2 * sum(b for _, b in moves))}},
        memory={"argument_size_in_bytes": _tree_nbytes(args),
                "temp_size_in_bytes": int(mode.peak)},
        n_params=M.count_params(args[0]),
        devices=sorted(mode.devices),
        off_meta={k: v[:4] for k, v in list(mode.off_meta.items())[:8]},
        kernels={k: dict(v) for k, v in tally.by_kernel.items()})
    del args, mode
    gc.collect()
    return res


def make_run_config(arch: str, cfg, shape, mcfg, run_overrides=None):
    """(model config, RunConfig factory) of a production cell: JAX's
    RUN_OVERRIDES, ``remat`` "full" and ``grad_accum`` 4 for train cells,
    ``moe_*`` overrides on the model, and the kernels for prefill and
    decode (``use_pallas``, as the serve runs)."""
    from ..configs.base import RunConfig
    overrides = dict(RUN_OVERRIDES.get(arch, {}))
    if shape.kind == "train":
        overrides.setdefault("remat", TRAIN_REMAT)
        overrides.setdefault("grad_accum", 4)
    else:
        overrides.setdefault("use_pallas", True)
    overrides.update(run_overrides or {})
    # model-level knobs ("moe_*" prefixed) apply to the ModelConfig
    moe_over = {k[4:]: overrides.pop(k) for k in list(overrides)
                if k.startswith("moe_")}
    if moe_over:
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **moe_over))

    def make_run(c):
        return RunConfig(model=c, shape=shape, mesh=mcfg, **overrides)
    return cfg, make_run


def run_cell(arch: str, shape_name: str, mesh_kind: str, tag: str = "",
             run_overrides: Optional[dict] = None, force: bool = False,
             verbose: bool = True, skip_extrapolation: bool = False,
             cfg=None, mesh_config=None, shape=None,
             art_dir: Optional[str] = None) -> dict:
    """Dry-run one cell and cache its JSON.  ``cfg`` (default: the
    registry's), ``mesh_config`` (default: the production mesh of
    ``mesh_kind``) and ``shape`` (a ``ShapeConfig``; default: the
    production cell ``shape_name``) let a caller size a cell at another
    width, mesh or shape."""
    path = cell_path(arch, shape_name, mesh_kind, tag, art_dir)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    from ..configs.base import SHAPES_BY_NAME
    from ..configs.registry import get_arch
    from ..models import model as M
    from . import rooflines
    from .mesh import make_mesh_from_config
    from .mesh import mesh_config as production_mesh
    from .steps import build_cell

    cfg = get_arch(arch) if cfg is None else cfg
    shape = SHAPES_BY_NAME[shape_name] if shape is None else shape
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "tag": tag, "status": "ok"}

    ok, reason = cell_runnable(cfg, shape)
    if not ok:
        result.update(status="skipped", reason=reason)
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: skipped",
                  flush=True)
        return result

    multi = mesh_kind == "multi"
    if multi:
        # the multi-pod pass proves the "pod" axis builds; the roofline
        # table is single-pod only — skip the extrapolation probes
        skip_extrapolation = True
    mcfg = production_mesh(multi_pod=multi) if mesh_config is None \
        else mesh_config
    mesh = make_mesh_from_config(mcfg, "meta")
    cfg, make_run = make_run_config(arch, cfg, shape, mcfg, run_overrides)

    try:
        # 1) the full-depth pass (the build) + memory
        full = _measure(build_cell(cfg, shape, make_run(cfg), mesh))
        cost1x, coll1x = full["cost"], full["collectives"]
        n_groups = _n_groups(cfg)
        result.update(
            n_params=full["n_params"],
            n_active_params=M.active_param_count(cfg, full["n_params"]),
            count_s=round(full["count_s"], 2),
            **{k: full[k] for k in ("memory", "devices", "off_meta",
                                    "kernels")})
        arg_b = full["memory"]["argument_size_in_bytes"]
        tmp_b = full["memory"]["temp_size_in_bytes"]
        result["hbm_bytes_per_device"] = arg_b + tmp_b
        result["fits_hbm"] = bool((arg_b + tmp_b) <= rooflines.HBM_BYTES)

        # 2) extrapolated costs from 1-group / 2-group probes
        if skip_extrapolation or n_groups <= 2:
            cost, coll = cost1x, coll1x
            result["extrapolation"] = "none (counted at full depth)"
        else:
            probes = []
            for g in (1, 2):
                rg = _reduced(cfg, g)
                p = _measure(build_cell(
                    rg, shape, dataclasses.replace(make_run(rg),
                                                   unroll_layers=True),
                    mesh))
                probes.append((p["cost"], p["collectives"]))
            (cost1, coll1), (cost2, coll2) = probes
            body = {k: cost2[k] - cost1[k] for k in _COST_KEYS}
            base = {k: cost1[k] - body[k] for k in _COST_KEYS}
            cost = _lin(base, body, n_groups)
            coll = {}
            for kind in _COLL_KINDS:
                b_body = coll2[kind]["bytes"] - coll1[kind]["bytes"]
                c_body = coll2[kind]["count"] - coll1[kind]["count"]
                coll[kind] = {
                    "bytes": coll1[kind]["bytes"] - b_body + n_groups * b_body,
                    "count": coll1[kind]["count"] - c_body + n_groups * c_body,
                }
            result["extrapolation"] = {
                "n_groups": n_groups, "cost_base": base, "cost_body": body,
                "cost_as_counted": cost1x, "coll_as_counted": coll1x}

        tokens = (shape.global_batch * shape.seq_len
                  if shape.kind in ("train", "prefill")
                  else shape.global_batch)
        # one card holds every stacked shard: the whole step is its work
        terms = rooflines.derive(cost, coll, 1, shape.kind,
                                 result["n_active_params"], tokens)
        result.update(
            cost=cost, collectives=coll, roofline=terms.as_dict(),
            tokens_per_step=tokens)
    except Exception as e:                                   # noqa: BLE001
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-4000:])
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    if verbose:
        s = result["status"]
        extra = ""
        if s == "ok":
            r = result["roofline"]
            extra = (f" count={result['count_s']}s"
                     f" bottleneck={r['bottleneck']}"
                     f" useful={r['useful_ratio']:.2f}"
                     f" fits_hbm={result['fits_hbm']}")
        elif s == "error":
            extra = " " + result["error"][:120]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: {s}{extra}",
              flush=True)
    return result


def parse_val(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-extrapolation", action="store_true")
    ap.add_argument("--tag", default="", help="variant tag")
    ap.add_argument("--set", action="append", default=[],
                    help="RunConfig override key=value (repeatable), e.g. "
                         "--set remat=dots --set grad_accum=8")
    ap.add_argument("--render", action="store_true",
                    help="print the roofline table of the cached cells of "
                         "each mesh (rooflines.render) and exit")
    args = ap.parse_args(argv)
    if args.render:
        from . import rooflines
        for mesh_kind in (["single", "multi"] if args.mesh == "both"
                          else [args.mesh]):
            print(f"[dryrun] {mesh_kind} mesh")
            rooflines.render(rooflines.load_cells(ARTIFACT_DIR, mesh_kind,
                                                  args.tag))
        return

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = parse_val(v)

    from ..configs.base import SHAPES
    from ..configs.registry import list_archs

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_err = 0
    t0 = time.monotonic()
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                r = run_cell(arch, shape_name, mesh_kind, tag=args.tag,
                             force=args.force, run_overrides=overrides,
                             skip_extrapolation=args.no_extrapolation)
                n_err += r["status"] == "error"
    print(f"[dryrun] done in {time.monotonic() - t0:.1f} s, {n_err} errors",
          flush=True)
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
