"""Checks of the model path that ``chip_smoke.py`` and the tests share:

  * ``FlashCheck`` holds every flash-attention kernel call against its
    plain version on the same inputs (the prefill's check run);
    ``GmmCheck`` does the same for the grouped-matmul kernel,
    ``ScanCheck`` for the selective-scan kernel and ``PackCheck`` for the
    pack kernels (exactly);
  * ``MoEStats`` keeps each MoE layer's dropped fraction and max load
    while the model runs unchanged; ``TrusteeDrops`` counts the expert
    rows the trustees' pack by expert drops past its slots;
  * ``DecodeLogits`` keeps the decode step's logits at one position while
    the serve loop runs unchanged.  These three keep what they count in
    device tensors and read nothing on the host while the model runs,
    so the decode step they wrap is captured and replayed
    (``core.compiled``) with them; the kernel checks compare on the host
    and run their step under ``compiled.disable()`` (entered inside a
    captured call, they raise); ``FinalHidden`` keeps an
    encoder-decoder model's final decoder hidden state while
    ``forward_loss`` runs unchanged;
  * ``logits_agreement`` holds the prefill's last-position logits against
    the serve's decode logits at that position; ``relative_agreement``
    holds two runs of one function (the kernels against the plain path)
    to a stated relative bound (``ENCDEC_RTOL`` for the encoder-decoder
    model, which has no prefill-versus-decode check: its serve never runs
    the encoder).
"""
from __future__ import annotations

import contextlib

import torch

from ..core import compiled
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels.flash_attention import tolerance as flash_tolerance
from ..kernels.grouped_matmul import tolerance as gmm_tolerance
from ..kernels.selective_scan import tolerance as scan_tolerance
from ..models import encdec
from ..models import model as M
from ..models import moe as moe_mod

# prefill against decode at the same position, on the relative RMS of the
# logit difference, ||a - b|| / ||b||.  f32: the same math in another
# order (one blocked softmax against per-shard partials), ~1e-6.  bf16:
# the two paths round activations to bf16 at different places (matmuls
# of (B*S, D) rows against (B, D) rows, P rounded in the flash kernel,
# the decode's f32 partials), 2^-9 relative a rounding, compounding over
# 36 residual layers and two sublayers each — a few percent at most.
PREFILL_DECODE_RTOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# the same for a MoE model in bf16: a token whose k-th and (k+1)-th
# router probabilities lie within the two paths' bf16 rounding of each
# other can take another expert in one of them, and the prefill (seq
# mode) and decode (mask-partition mode) have other capacities, so other
# rows may drop — at the channel, or at the trustees' pack by expert
# past its cap2 slots (``TrusteeDrops``); each such token moves by a
# whole expert's output
MOE_PREFILL_DECODE_RTOL = 1e-1
# the same for a model with Mamba layers in bf16: both paths round dt to
# bf16 before the scan, so a rounding that differs (their GEMMs and scans
# sum in other orders) moves a channel's decay and input for every step
# its state keeps them, through 64 such layers (in f32 the two agree to
# 2.5e-5).  On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 8:
# falcon-mamba-7b at full width, random weights, 8 prompts of 128
# tokens, position 127) four weight and prompt seeds read 7.184%,
# 7.528%, 7.600% and 7.569% while the prefill summed the conv's products
# in bf16 and the decode in f32: the bound is the largest with about a
# third of headroom (2.4 points, six times the readings' spread of 0.42)
SSM_PREFILL_DECODE_RTOL = 1e-1
# seamless-m4t-large-v2 on the card in bf16, the flash kernel's path
# (use_pallas) against the plain path on the same weights and inputs:
# "memory", the encoder memory's relative RMS, and "hidden", the relative
# RMS of forward_loss's final decoder hidden state (``FinalHidden``: what
# the causal self-attention and the cross-attention over the memory
# computed, before the cross-entropy averages it away), are the dense
# prefill's bound for the same reason (bf16 rounded at other places — P
# in the kernel, the plain path's blockwise f32 softmax — compounding over
# 24 residual layers of two or three sublayers); "loss", forward_loss's
# mean nll, relative: about ten times the largest reading on an NVIDIA
# H100 80GB HBM3 at 700 W (chip_smoke.py phase 11, S_src 2048, S_tgt 512:
# 2.6e-5), an average over 2048 target positions of per-token errors of
# either sign
ENCDEC_RTOL = {"memory": 5e-2, "hidden": 5e-2, "loss": 3e-4}


def prefill_decode_rtol(cfg, dtype: torch.dtype) -> float:
    """The prefill-versus-decode tolerance of ``cfg`` in ``dtype``: in
    bf16 the largest of the dense, MoE and Mamba bounds its layers call
    for."""
    rtol = PREFILL_DECODE_RTOL[dtype]
    if dtype != torch.bfloat16:
        return rtol
    if cfg.ffn_kind != "dense":
        rtol = max(rtol, MOE_PREFILL_DECODE_RTOL)
    if "mamba" in cfg.block_pattern:
        rtol = max(rtol, SSM_PREFILL_DECODE_RTOL)
    return rtol


def flash_within(got: torch.Tensor, want: torch.Tensor, v: torch.Tensor):
    """(within the tolerance, max abs err) of a flash-attention kernel
    output against its plain version (``flash_attention.tolerance``)."""
    rtol, atol = flash_tolerance(v)
    err = (got.float() - want.float()).abs()
    return (bool((err <= atol + rtol * want.float().abs()).all()),
            float(err.max()) if err.numel() else 0.0)


class _KernelCheck:
    """Inside the context, every kernel call of ``kops.<name>`` is also
    run through the plain version on the same arguments and compared:
    ``calls``, ``max_err`` and ``bad`` (calls beyond the tolerance)
    accumulate, ``first`` keeps the first call's arguments and ``shapes``
    the distinct argument shapes.  The caller's code runs unchanged; only
    the module attribute is wrapped.  The comparison reads the host, so
    the body runs under ``compiled.disable()`` (the captured steps run
    eagerly), and entering the context inside a captured call raises —
    unless the check compares on the device (``on_device``, with
    ``_within_device``): then its calls, errors and bad calls are device
    counts, and a captured step keeps checking every call in its
    replays."""
    name = label = ""
    on_device = False

    def __init__(self):
        self.calls, self.bad, self.max_err = 0, 0, 0.0
        self.first, self.shapes = None, []
        self._acc = None

    def __enter__(self):
        if not self.on_device:
            compiled.forbid_host_read(type(self).__name__)
        self._eager = compiled.disable() if not self.on_device \
            else contextlib.nullcontext()
        self._eager.__enter__()
        self._fn = getattr(kops, self.name)
        setattr(kops, self.name, self._call)
        return self

    def __exit__(self, *exc):
        setattr(kops, self.name, self._fn)
        self._eager.__exit__(*exc)

    def _plain(self, *args, **kw):
        return self._fn(*args, impl="ref", **kw)

    def _call(self, *args, impl="kernel", **kw):
        out = self._fn(*args, impl=impl, **kw)
        if impl == "kernel":
            call = self._args(*args, **kw)
            if self.first is None:
                self.first = call
            shape = tuple(tuple(a.shape) for a in call
                          if isinstance(a, torch.Tensor))
            if shape not in self.shapes:
                self.shapes.append(shape)
            if self.on_device:
                bad, err = self._within_device(
                    out, self._plain(*args, **kw), call)
                if self._acc is None:
                    self._acc = torch.zeros(3, dtype=torch.float64,
                                            device=bad.device)
                self._acc[0].add_(1.0)
                self._acc[1].add_(bad)
                self._acc[2].copy_(torch.maximum(self._acc[2], err))
                return out
            ok, err = self._within(out, self._plain(*args, **kw), call)
            self.calls += 1
            self.bad += int(not ok)
            self.max_err = max(self.max_err, err)
        return out

    def summary(self):
        if self._acc is not None:
            calls, bad, err = self._acc.tolist()
            self.calls, self.bad = int(calls), int(bad)
            self.max_err = err
        p = self.label
        return {f"{p}_calls": self.calls, f"{p}_max_abs_err": self.max_err,
                f"{p}_calls_out_of_tolerance": self.bad,
                f"{p}_shapes": self.shapes}


class FlashCheck(_KernelCheck):
    """``_KernelCheck`` of ``flash_attention``; ``first`` is (q, k, v,
    q_offset, causal, scale).  The plain version runs one sequence of the
    batch at a time (the same function: the sequences are independent),
    so its f32 scores are (Hq, Sq, Skv), 0.67 GB at qwen1.5-32b's prefill
    (40 heads x 2048^2), not the batch's 2.7 GB, beside the model's 70 GB
    of weights."""
    name, label = "flash_attention", "flash"

    def _plain(self, q, k, v, *rest, **kw):
        return torch.cat([self._fn(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                   *rest, impl="ref", **kw)
                          for i in range(q.shape[0])])

    @staticmethod
    def _args(q, k, v, q_offset=None, causal=True, scale=None):
        return q, k, v, q_offset, causal, scale

    @staticmethod
    def _within(out, want, call):
        return flash_within(out, want, call[2])


def gmm_within(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor,
               w: torch.Tensor):
    """(within the tolerance, max abs err) of a grouped-matmul kernel
    output against its plain version (``grouped_matmul.tolerance``)."""
    rtol, atol = gmm_tolerance(x, w)
    err = (got.float() - want.float()).abs()
    return (bool((err <= atol + rtol * want.float().abs()).all()),
            float(err.max()) if err.numel() else 0.0)


def gmm_chunks(x, w, plain_bytes: int):
    """Slices of ``x`` / ``w``'s experts, each chunk's weights at most
    ``plain_bytes`` in f32 (one expert at least)."""
    step = max(1, plain_bytes // (4 * w[0].numel()))
    return [slice(i, i + step) for i in range(0, x.shape[0], step)]


class ChunkedPlainGmm:
    """Inside the context the plain grouped matmul (``ref.grouped_matmul``,
    which the model's plain path calls) runs a chunk of experts at a
    time, as ``GmmCheck`` runs it: the same function (the experts are
    independent), each chunk's weights at most ``GmmCheck.plain_bytes``
    in f32, so that a plain path whose expert leaf does not fit the card
    in f32 beside its weights (arctic-480b's) runs."""

    def __enter__(self):
        self._fn = kref.grouped_matmul
        kref.grouped_matmul = self._call
        return self

    def __exit__(self, *exc):
        kref.grouped_matmul = self._fn

    def _call(self, x, w, counts=None):
        return torch.cat([
            self._fn(x[c], w[c], None if counts is None else counts[c])
            for c in gmm_chunks(x, w, GmmCheck.plain_bytes)])


class GmmCheck(_KernelCheck):
    """``_KernelCheck`` of ``grouped_matmul``; ``first`` is (x, w,
    counts).  ``tiles`` and ``filled_tiles`` count the checked calls'
    128-row tiles and those that hold a filled row (every tile where a
    call has no counts).  The plain version and the tolerance run a chunk
    of experts at a time (the same functions: the experts are
    independent, the tolerance elementwise), each chunk's weights at most
    ``plain_bytes`` in f32: both take ``w.float()``, and arctic-480b's
    (128, 7168, 4864) expert leaf is 17.8 GB of f32 beside 55.4 GB of
    weights."""
    name, label = "grouped_matmul", "gmm"
    plain_bytes = 1 << 30

    def __init__(self):
        super().__init__()
        self.tiles = self.filled_tiles = 0

    def _chunks(self, x, w):
        return gmm_chunks(x, w, self.plain_bytes)

    def _plain(self, x, w, counts=None, **kw):
        return torch.cat([
            self._fn(x[c], w[c], None if counts is None else counts[c],
                     impl="ref", **kw) for c in self._chunks(x, w)])

    @staticmethod
    def _args(x, w, counts=None):
        return x, w, counts

    def _within(self, out, want, call):
        x, w, counts = call
        e, c = x.shape[:2]
        self.tiles += e * -(-c // 128)
        self.filled_tiles += e * -(-c // 128) if counts is None else \
            int(((counts.long() + 127) // 128).sum())
        ok, err = True, 0.0
        for k in self._chunks(x, w):
            part_ok, part_err = gmm_within(out[k], want[k], x[k], w[k])
            ok, err = ok and part_ok, max(err, part_err)
        return ok, err

    def summary(self):
        return dict(super().summary(), gmm_tiles=self.tiles,
                    gmm_filled_tiles=self.filled_tiles)


def pack_within(got, want):
    """(every output equal, max abs err) of a pack kernel call against its
    plain version: the pack moves 32-bit words, so it is held exactly."""
    err = 0.0
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            err = max(err, float((a.double() - b.double()).abs().max())
                      if a.numel() and a.shape == b.shape else float("inf"))
    return err == 0.0, err


class PackCheck(_KernelCheck):
    """``_KernelCheck`` of ``delegation_pack`` (all six outputs, exact);
    ``first`` is (dst, words, n_trustees, capacity, capacity2).  It
    compares on the device, so the rounds it wraps stay captured."""
    name, label = "delegation_pack", "pack"
    on_device = True

    @staticmethod
    def _within_device(out, want, call):
        """(1 if any output differs else 0, max abs err), f64 device
        scalars: ``pack_within`` without a host read."""
        dev = out[0].device
        bad = torch.zeros((), dtype=torch.float64, device=dev)
        err = torch.zeros((), dtype=torch.float64, device=dev)
        for a, b in zip(out, want):
            if a.shape != b.shape:
                bad = bad + 1.0
                err = err + float("inf")
            elif a.numel():
                diff = (a.double() - b.double()).abs().max()
                bad = torch.maximum(bad, (a != b).any().double())
                err = torch.maximum(err, diff)
        return torch.clamp(bad, max=1.0), err

    @staticmethod
    def _args(dst, words, n_trustees, capacity, capacity2=0):
        return dst, words, n_trustees, capacity, capacity2

    @staticmethod
    def _within(out, want, call):
        return pack_within(out, want)


def scan_within(got, want, call):
    """(within the tolerance, max abs err) of a selective-scan kernel
    output (y, h_final) against its plain version on the arguments
    ``call`` = (x, dt, a, b, c, d, h0) (``selective_scan.tolerance``)."""
    rtol, atol_y, atol_h = scan_tolerance(*call)
    ey = (got[0].float() - want[0].float()).abs()
    eh = (got[1] - want[1]).abs()
    ok = bool((ey <= atol_y + rtol * want[0].float().abs()).all()) \
        and bool((eh <= atol_h).all())
    err = max(float(ey.max()) if ey.numel() else 0.0,
              float(eh.max()) if eh.numel() else 0.0)
    return ok, err


class ScanCheck(_KernelCheck):
    """``_KernelCheck`` of ``selective_scan``; ``first`` is (x, dt, a, b,
    c, d, h0)."""
    name, label = "selective_scan", "scan"

    @staticmethod
    def _args(x, dt, a, b, c, d, h0=None):
        return x, dt, a, b, c, d, h0

    @staticmethod
    def _within(out, want, call):
        return scan_within(out, want, call)


class _DeviceTally:
    """A device tensor of running counts that a wrapped model function
    updates in place (no host read): the same updates run eagerly, in a
    capture and in every replay."""

    def _tally(self, like: torch.Tensor, n: int, dtype) -> torch.Tensor:
        if self._acc is None:
            self._acc = torch.zeros(n, dtype=dtype, device=like.device)
        return self._acc


class MoEStats(_DeviceTally):
    """Inside the context, every ``moe.moe_block`` call's aux metrics are
    kept on the device (the calls, the sum and max of the dropped
    fractions of tokens, the max load); the model runs unchanged, and a
    captured decode step keeps them in its replays.  ``summary()`` reads
    them."""

    def __enter__(self):
        self._acc = None
        self._block = moe_mod.moe_block
        moe_mod.moe_block = self._call
        return self

    def __exit__(self, *exc):
        moe_mod.moe_block = self._block

    def _call(self, params, x, cfg, run=None):
        y, aux = self._block(params, x, cfg, run)
        acc = self._tally(x, 4, torch.float64)
        d = aux["moe_dropped_frac"].detach().double()
        load = aux["moe_max_load"].detach().double()
        acc[0].add_(1.0)
        acc[1].add_(d)
        acc[2].copy_(torch.maximum(acc[2], d))
        acc[3].copy_(torch.maximum(acc[3], load))
        return y, aux

    def summary(self):
        n, total, worst, load = ([0.0] * 4 if self._acc is None
                                 else self._acc.tolist())
        n = int(n)
        return {"moe_calls": n,
                "moe_dropped_frac_mean": total / max(n, 1),
                "moe_dropped_frac_max": worst,
                "moe_max_load": load}


class TrusteeDrops(_DeviceTally):
    """Inside the context, the expert rows each MoE trustee's pack by
    expert drops past its ``cap2`` slots (rows past them answer zeros;
    the model's ``moe_dropped_frac`` counts the channel's drops only, as
    JAX's does) are counted on the kernel path, on the device: the packs,
    the rows dropped and the rows packed.  The pack by expert is the one
    with no second block (``capacity2`` 0); the model runs unchanged."""

    def __enter__(self):
        self._acc = None
        self._pack = kops.delegation_pack
        kops.delegation_pack = self._call
        return self

    def __exit__(self, *exc):
        kops.delegation_pack = self._pack

    def _call(self, dst, words, n_trustees, capacity, capacity2=0, **kw):
        out = self._pack(dst, words, n_trustees, capacity, capacity2, **kw)
        if capacity2 == 0:
            acc = self._tally(dst, 3, torch.int64)
            acc[0].add_(1)
            acc[1].add_(((out[4] < 0) & (dst >= 0)).sum())
            acc[2].add_((dst >= 0).sum())
        return out

    def total(self):
        """(rows dropped, rows packed) over every pack by expert."""
        if self._acc is None:
            return 0, 0
        _n, dropped, rows = self._acc.tolist()
        return dropped, rows


class DecodeLogits:
    """Inside the context, the logits of the decode step at position
    ``pos`` (every row of the batch at that position) are kept in
    ``logits``; the serve loop runs unchanged (``M.decode_step`` is
    wrapped).  The step copies them into a device buffer when its
    positions read ``pos`` (no host read), so a captured decode step
    keeps them in its replays; ``logits`` is None when no step ran at
    ``pos``."""

    def __init__(self, pos: int):
        self.pos = pos
        self._buf = self._hit = None

    def __enter__(self):
        self._step = M.decode_step
        M.decode_step = self._call
        return self

    def __exit__(self, *exc):
        M.decode_step = self._step

    def _call(self, params, cache, tokens, pos, cfg, run=None):
        logits, cache = self._step(params, cache, tokens, pos, cfg, run)
        if self._buf is None:
            self._buf = torch.zeros_like(logits)
            self._hit = torch.zeros((), dtype=torch.bool,
                                    device=logits.device)
        at = pos[0] == self.pos
        self._buf.copy_(torch.where(at, logits, self._buf))
        self._hit |= at
        return logits, cache

    @property
    def logits(self):
        if self._buf is None or not bool(self._hit):
            return None
        return self._buf.clone()


class FinalHidden:
    """Inside the context, the final decoder hidden state that an
    encoder-decoder model's ``forward_loss`` hands to the cross-entropy
    (B, S, D, after the final norm) is kept in ``hidden``; the loss runs
    unchanged (``encdec.delegated_softmax_xent`` is wrapped)."""

    def __enter__(self):
        self.hidden = None
        self._xent = encdec.delegated_softmax_xent
        encdec.delegated_softmax_xent = self._call
        return self

    def __exit__(self, *exc):
        encdec.delegated_softmax_xent = self._xent

    def _call(self, x, *args, **kw):
        self.hidden = x.detach().clone()
        return self._xent(x, *args, **kw)


def relative_agreement(got: torch.Tensor, want: torch.Tensor,
                       rtol: float) -> dict:
    """``got`` against ``want``: the relative RMS of the difference,
    ||got - want|| / ||want||, held to ``rtol``, and the max abs
    difference."""
    a, b = got.float(), want.float()
    rel = float((a - b).norm() / b.norm())
    return {"rel_rms": rel, "max_abs": float((a - b).abs().max()),
            "rtol": rtol, "ok": rel <= rtol}


def logits_agreement(prefill: torch.Tensor, decode: torch.Tensor,
                     dtype: torch.dtype, cfg=None) -> dict:
    """The prefill's last-position logits against the decode's at the same
    position: ``relative_agreement`` held to ``prefill_decode_rtol`` of
    ``cfg`` (a dense model's when None), and the share of rows whose
    argmax agrees."""
    rtol = PREFILL_DECODE_RTOL[dtype] if cfg is None \
        else prefill_decode_rtol(cfg, dtype)
    agree = float((prefill.float().argmax(-1) == decode.float().argmax(-1))
                  .float().mean())
    return dict(relative_agreement(prefill, decode, rtol),
                argmax_agree=agree)
