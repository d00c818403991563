"""Autoregressive generation on the port: the decoder model, its on-disk
form, the reference decode loops and the continuous-batching scheduler —
the PyTorch port of ``paddle_tpu/serving/generation.py``.

  model     — :class:`TransformerDecoderModel`, a pre-LN decoder LM as
              plain functions over a parameter dict of tensors (the same
              tree as the reference's params pytree: ``embed``,
              ``blocks[i].{ln1_s, ln1_b, wq, wk, wv, wo, ln2_s, ln2_b, w1,
              b1, w2, b2}``, ``lnf_s``, ``lnf_b``, ``head``).
  engines   — :class:`DecodeEngine`, dense per-slot caches ``[max_slots,
              max_len, heads, head_dim]`` (the serving default, and the
              draft engine of speculative decoding), and the paged
              engine of ``serving/paged_kv.py``.
  schedule  — :class:`GenerationScheduler` runs either engine on a loop
              thread with CONTINUOUS batching: between decode steps
              queued requests are admitted into free slots and finished
              sequences are evicted, so the device batch stays full under
              load; with speculative rounds over a draft engine, tenant
              budgets and priority classes over a held lane, preemption
              to that lane, an SLO control loop and brownout shedding
              (:class:`BrownoutController`).

PyTorch idiom in place of JAX's: the engine's KV pools are updated IN
PLACE (``index_put_``) where the reference used donated functional
``.at[].set`` updates, so a failure mid-step leaves the pools partly
written — the engine is then marked dead and raises
:class:`DeviceStateError` until :meth:`reset`. Temperature draws are a
pure function of (seed, decode step, slot): a counter hash feeds a
Gumbel-max draw (:func:`draw_tokens`), so a replayed CUDA graph draws
what the step-at-a-time loop draws. That stream is not ``jax.random``'s;
greedy decoding is deterministic in both.

Quantized serving: int8/fp8 KV pages (``kv_quant_dtype``; the append
and the prefill's dequantizing gather are plain PyTorch in
``ops.kv_quant``, decode attention is K3-quant) and weight-only quantized
decoders (:func:`quantize_decoder_dir` → :func:`load_decoder`: ``{"qw",
"scale"}`` leaves, dequantized before each matmul).

KV-page handoff: a paged engine with a ``prefix_tier`` maps pages another
process prefilled (``serving/kv_transfer.py``, ``serving/prefix_tier.py``);
the SLO summary reports ``imported_pages`` beside ``prefix_hit_pages``.

Not ported yet: the runlog's per-request summary records.
"""

import contextlib
import json
import math
import os
import queue
import shutil
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..convert import array_to_tensor, quant_payload_to_tensor
from ..observability import catalog, tracing
from ..ops import kv_quant as kvq
from ..ops import paged_attention
from ..ops.attention import (decode_cache_attention, dot_product_attention,
                             paged_chunk_attention)
from ..registry import _M32, _mix32
from .batcher import (DeadlineExceededError, DrainRateEstimator,
                      OverloadedError, PendingResult, ServingClosedError,
                      resolve_serving_knobs)

__all__ = [
    "TransformerDecoderModel", "DecodeEngine", "DeviceStateError",
    "BrownoutController", "GenerationScheduler", "full_recompute_generate",
    "greedy_generate", "resolve_generation_knobs", "resolve_tenant_knobs",
    "save_decoder", "load_decoder", "quantize_decoder_dir",
    "params_to_device", "sample_tokens", "draw_tokens",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_BLOCK_KEYS = ("ln1_s", "ln1_b", "wq", "wk", "wv", "wo",
               "ln2_s", "ln2_b", "w1", "b1", "w2", "b2")


class DeviceStateError(RuntimeError):
    """A prefill/decode call failed after it began updating the engine's
    KV pools in place — the device state is unknown and every slot's
    cache must be considered lost. :meth:`PagedDecodeEngine.reset` before
    further use (the scheduler does this, failing the in-flight cohort)."""


def resolve_generation_knobs(max_slots=None, max_len=None,
                             prefill_buckets=None, *, page_size=None,
                             num_pages=None, speculative_k=None,
                             kv_quant_dtype=None, kv_quant_group=None,
                             megastep_k=None, paged=False):
    """Resolve ``(max_slots, max_len, buckets)`` from explicit values or
    the ``FLAGS_generation_*`` defaults, validating each (errors name the
    flag). Buckets come back as a sorted tuple clipped to lengths that
    leave room for one generated token. With ``paged=True`` the return
    extends to ``(..., page_size, num_pages, speculative_k,
    kv_quant_dtype, kv_quant_group, megastep_k)``; ``num_pages=0`` sizes
    the pool to the dense-equivalent budget ``ceil(max_slots × max_len /
    page_size)``, DOUBLED when the pages are quantized (int8/fp8 pages
    cost half the bf16 bytes); ``speculative_k`` must leave a verify
    chunk room beside a one-token prompt (``< max_len - 1``);
    ``kv_quant_group=0`` resolves to one group per page; ``megastep_k=0``
    resolves to ``min(8, max_len - 1)``."""
    from .. import flags

    def _int(value, flag, lo):
        try:
            v = int(value)
        except (TypeError, ValueError):
            raise ValueError("FLAGS_%s must be an integer (got %r)"
                             % (flag, value)) from None
        if v < lo:
            raise ValueError("FLAGS_%s must be >= %d (got %d)"
                             % (flag, lo, v))
        return v

    max_slots = _int(flags.generation_max_slots if max_slots is None
                     else max_slots, "generation_max_slots", 1)
    max_len = _int(flags.generation_max_len if max_len is None
                   else max_len, "generation_max_len", 2)
    raw = flags.generation_prefill_buckets if prefill_buckets is None \
        else prefill_buckets
    if isinstance(raw, str):
        parts = [p for p in raw.replace(" ", "").split(",") if p]
    else:
        try:
            parts = list(raw)
        except TypeError:
            raise ValueError(
                "FLAGS_generation_prefill_buckets must be a comma-separated "
                "string or a sequence of integers (got %r)" % (raw,)) \
                from None
    buckets = [_int(p, "generation_prefill_buckets", 1) for p in parts]
    usable = tuple(sorted({b for b in buckets if b <= max_len - 1}))
    if not usable:
        raise ValueError(
            "FLAGS_generation_prefill_buckets=%r has no bucket <= "
            "FLAGS_generation_max_len - 1 = %d (prompts must leave room "
            "for at least one generated token)" % (raw, max_len - 1))
    if not paged:
        return max_slots, max_len, usable
    page_size = _int(flags.kv_page_size if page_size is None
                     else page_size, "kv_page_size", 1)
    num_pages = _int(flags.kv_num_pages if num_pages is None
                     else num_pages, "kv_num_pages", 0)
    kv_quant_dtype = flags.kv_quant_dtype if kv_quant_dtype is None \
        else kv_quant_dtype
    if kv_quant_dtype not in kvq.QUANT_DTYPES:
        raise ValueError("FLAGS_kv_quant_dtype must be one of %s (got %r)"
                         % ("|".join(kvq.QUANT_DTYPES), kv_quant_dtype))
    kv_quant_group = _int(flags.kv_quant_group if kv_quant_group is None
                          else kv_quant_group, "kv_quant_group", 0)
    if kv_quant_group == 0:
        kv_quant_group = page_size  # one scale group per page
    if page_size % kv_quant_group:
        raise ValueError(
            "FLAGS_kv_quant_group=%d must divide FLAGS_kv_page_size=%d "
            "(scale groups tile a page)" % (kv_quant_group, page_size))
    pages_per_seq = -(-max_len // page_size)
    if num_pages == 0:
        num_pages = -(-max_slots * max_len // page_size)
        if kv_quant_dtype != "off":
            num_pages *= 2   # the same bytes hold twice the pages
    if num_pages < pages_per_seq:
        raise ValueError(
            "FLAGS_kv_num_pages=%d cannot hold even one full sequence: "
            "FLAGS_generation_max_len=%d at FLAGS_kv_page_size=%d needs "
            "%d pages" % (num_pages, max_len, page_size, pages_per_seq))
    speculative_k = _int(flags.speculative_k if speculative_k is None
                         else speculative_k, "speculative_k", 0)
    if speculative_k >= max_len - 1:
        raise ValueError(
            "FLAGS_speculative_k=%d must be < FLAGS_generation_max_len "
            "- 1 = %d (a verify chunk must fit in the cache beside at "
            "least a one-token prompt)" % (speculative_k, max_len - 1))
    megastep_k = _int(flags.generation_megastep_k if megastep_k is None
                      else megastep_k, "generation_megastep_k", 0)
    if megastep_k == 0:
        megastep_k = min(8, max_len - 1)
    if megastep_k >= max_len:
        raise ValueError(
            "FLAGS_generation_megastep_k=%d must be < FLAGS_generation_"
            "max_len=%d (one megastep's tokens must fit a slot's cache "
            "beside at least a one-token prompt)" % (megastep_k, max_len))
    return (max_slots, max_len, usable, page_size, num_pages,
            speculative_k, kv_quant_dtype, kv_quant_group, megastep_k)


PRIORITY_CLASSES = ("high", "low")


def resolve_tenant_knobs(token_budget=None, token_budget_map=None,
                         budget_window_s=None, held_depth=None,
                         slo_ttft_ms=None, slo_tpot_ms=None,
                         slo_sustain_s=None):
    """Resolve the multi-tenant isolation and SLO knobs from explicit
    values or the ``FLAGS_tenant_*`` / ``FLAGS_slo_*`` defaults,
    validating each (errors name the flag). Returns::

        {"token_budget": int,          # 0 = unlimited
         "token_budget_map": {tenant: int},
         "budget_window_s": float,
         "held_depth": int,
         "slo_ttft_ms": {class: ms},   # only classes with a target > 0
         "slo_tpot_ms": {class: ms},
         "slo_sustain_s": float}

    The map flags parse ``"key=value,key=value"`` (or take a dict); SLO
    map keys must be priority classes (``high``/``low``), and a 0 value
    (or an absent class) means no target for that class."""
    from .. import flags

    def _int(value, flag, lo):
        try:
            v = int(value)
        except (TypeError, ValueError):
            raise ValueError("FLAGS_%s must be an integer (got %r)"
                             % (flag, value)) from None
        if v < lo:
            raise ValueError("FLAGS_%s must be >= %d (got %d)"
                             % (flag, lo, v))
        return v

    def _float(value, flag, lo):
        try:
            v = float(value)
        except (TypeError, ValueError):
            raise ValueError("FLAGS_%s must be a number (got %r)"
                             % (flag, value)) from None
        if not math.isfinite(v) or v < lo:
            raise ValueError("FLAGS_%s must be a finite number >= %g "
                             "(got %r)" % (flag, lo, value))
        return v

    def _map(raw, flag, keys=None):
        if raw is None:
            raw = ""
        if isinstance(raw, dict):
            items = list(raw.items())
        else:
            items = []
            for part in str(raw).replace(" ", "").split(","):
                if not part:
                    continue
                if "=" not in part:
                    raise ValueError("FLAGS_%s entries must look like "
                                     "key=value (got %r)" % (flag, part))
                items.append(tuple(part.split("=", 1)))
        out = {}
        for k, v in items:
            if not k:
                raise ValueError("FLAGS_%s has an entry with an empty key"
                                 % flag)
            if keys is not None and k not in keys:
                raise ValueError("FLAGS_%s keys must be one of %s (got %r)"
                                 % (flag, "|".join(keys), k))
            out[k] = v
        return out

    def _pick(value, flag):
        return getattr(flags, flag) if value is None else value

    budget = _int(_pick(token_budget, "tenant_token_budget"),
                  "tenant_token_budget", 0)
    budget_map = {k: _int(v, "tenant_token_budget_map", 0)
                  for k, v in _map(_pick(token_budget_map,
                                         "tenant_token_budget_map"),
                                   "tenant_token_budget_map").items()}
    window_s = _float(_pick(budget_window_s, "tenant_budget_window_s"),
                      "tenant_budget_window_s", 1e-3)
    depth = _int(_pick(held_depth, "tenant_held_depth"),
                 "tenant_held_depth", 1)
    slo = {}
    for flag, raw in (("slo_ttft_ms", slo_ttft_ms),
                      ("slo_tpot_ms", slo_tpot_ms)):
        targets = {k: _float(v, flag, 0.0) for k, v in _map(
            _pick(raw, flag), flag, keys=PRIORITY_CLASSES).items()}
        # a 0 target = no target for the class: dropped, so the control
        # loop reads key presence as "target configured"
        slo[flag] = {k: v for k, v in targets.items() if v > 0}
    sustain = _float(_pick(slo_sustain_s, "slo_sustain_s"),
                     "slo_sustain_s", 0.0)
    return {"token_budget": budget, "token_budget_map": budget_map,
            "budget_window_s": window_s, "held_depth": depth,
            "slo_ttft_ms": slo["slo_ttft_ms"],
            "slo_tpot_ms": slo["slo_tpot_ms"], "slo_sustain_s": sustain}


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def _layer_norm(x, scale, bias, eps=1e-6):
    """The reference's layer norm: eps 1e-6, computed in x's dtype."""
    m = x.mean(dim=-1, keepdim=True)
    v = (x - m).square().mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * scale + bias


def _leaf_to(v, device):
    if isinstance(v, dict):   # a weight-quantized {"qw", "scale"} leaf
        return {part: t.to(device) for part, t in v.items()}
    return v.to(device)


def params_to_device(params, device):
    """The parameter dict with every tensor on ``device``."""
    return {k: ([{n: _leaf_to(t, device) for n, t in blk.items()}
                 for blk in v] if k == "blocks" else _leaf_to(v, device))
            for k, v in params.items()}


def _wmat(w, dtype):
    """Dequant-on-use weight access: a weight-quantized ``{"qw": int8/fp8
    [r, c], "scale": fp32 [c]}`` leaf is dequantized here, before the
    matmul that consumes it; a full-precision weight passes through."""
    if isinstance(w, dict):
        return kvq.dequantize_weight(w["qw"], w["scale"], dtype)
    return w


class TransformerDecoderModel:
    """Minimal pre-LN transformer decoder LM over a parameter dict —
    the model surface :class:`~.paged_kv.PagedDecodeEngine` drives.
    Sinusoidal positions (parameter-free, valid at any position).

    ``head_init_std`` defaults wide: untrained near-uniform logits would
    make every argmax a near-tie, and the token-identity checks would
    measure rounding instead of decoding."""

    def __init__(self, vocab_size, dim=64, n_heads=4, n_layers=2,
                 ffn_mult=4, head_init_std=0.5, dtype=torch.float32):
        if dim % n_heads:
            raise ValueError("dim %d not divisible by n_heads %d"
                             % (dim, n_heads))
        if dim % 2:
            raise ValueError("dim must be even (sinusoidal positions)")
        if dtype not in _DTYPES.values():
            raise ValueError("dtype must be float32 or bfloat16 (got %r)"
                             % (dtype,))
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.n_heads = int(n_heads)
        self.n_layers = int(n_layers)
        self.ffn_dim = int(dim * ffn_mult)
        self.head_dim = self.dim // self.n_heads
        self.head_init_std = float(head_init_std)
        self.dtype = dtype
        self.weight_quant = None  # set by load_decoder (quantized decoders)

    def init_params(self, seed=0, device=None):
        """Random weights from ``np.random.RandomState(seed)``, drawn in the
        reference's order, so a seed gives the same fp32 weights in both
        packages."""
        dev = resolve_device(device)
        rng = np.random.RandomState(seed)
        D, F_, V = self.dim, self.ffn_dim, self.vocab_size

        def t(arr):
            return torch.from_numpy(np.asarray(arr, np.float32)).to(
                device=dev, dtype=self.dtype)

        def w(rows, cols, std=None):
            std = (1.0 / np.sqrt(rows)) if std is None else std
            return t(rng.normal(0.0, std, (rows, cols)))

        def ones(n):
            return torch.ones(n, dtype=self.dtype, device=dev)

        def zeros(n):
            return torch.zeros(n, dtype=self.dtype, device=dev)

        blocks = []
        for _ in range(self.n_layers):
            blocks.append({
                "ln1_s": ones(D), "ln1_b": zeros(D),
                "wq": w(D, D), "wk": w(D, D), "wv": w(D, D), "wo": w(D, D),
                "ln2_s": ones(D), "ln2_b": zeros(D),
                "w1": w(D, F_), "b1": zeros(F_),
                "w2": w(F_, D), "b2": zeros(D),
            })
        return {
            "embed": t(rng.normal(0.0, 1.0, (V, D))),
            "blocks": blocks,
            "lnf_s": ones(D), "lnf_b": zeros(D),
            "head": w(D, V, std=self.head_init_std),
        }

    def _positions(self, positions):
        """Sinusoidal table, computed in fp32 and cast to the model dtype."""
        half = self.dim // 2
        freqs = torch.exp(
            torch.arange(half, dtype=torch.float32, device=positions.device)
            * (-math.log(10000.0) / max(half - 1, 1)))
        ang = positions[..., None].float() * freqs
        return torch.cat([torch.sin(ang), torch.cos(ang)],
                         dim=-1).to(self.dtype)

    def _qkv(self, blk, h):
        hd = h.shape[:-1] + (self.n_heads, self.head_dim)
        return tuple((h @ _wmat(blk[n], self.dtype)).reshape(hd)
                     for n in ("wq", "wk", "wv"))

    def _embed(self, params, tokens):
        """Token embedding lookup; a quantized table gathers the int8/fp8
        rows first and dequantizes just them."""
        emb = params["embed"]
        if isinstance(emb, dict):
            rows = kvq.gather_rows(emb["qw"], tokens.long())
            return (rows.float() * emb["scale"]).to(self.dtype)
        return emb[tokens.long()]

    def _ffn(self, blk, x):
        h = _layer_norm(x, blk["ln2_s"], blk["ln2_b"])
        # the reference's jax.nn.gelu defaults to the tanh approximation
        return x + F.gelu(h @ _wmat(blk["w1"], self.dtype) + blk["b1"],
                          approximate="tanh") @ _wmat(blk["w2"], self.dtype) \
            + blk["b2"]

    def last_logits_and_kv(self, params, tokens, lengths, need_kv=True):
        """Full causal forward — the full-recompute baseline. ``tokens``
        [B, L] (padded), ``lengths`` [B] → (logits [B, V] at each row's
        last valid position, ks, vs: per-layer tuples of [B, L, heads,
        head_dim])."""
        B, L = tokens.shape
        x = self._embed(params, tokens) + self._positions(
            torch.arange(L, device=tokens.device))[None]
        ks, vs = [], []
        for blk in params["blocks"]:
            h = _layer_norm(x, blk["ln1_s"], blk["ln1_b"])
            q, k, v = self._qkv(blk, h)
            a = dot_product_attention(q, k, v, causal=True, layout="bshd")
            x = x + a.reshape(B, L, self.dim) @ _wmat(blk["wo"], self.dtype)
            x = self._ffn(blk, x)
            if need_kv:
                ks.append(k)
                vs.append(v)
        x = _layer_norm(x, params["lnf_s"], params["lnf_b"])
        last = x[torch.arange(B, device=x.device), lengths.long() - 1]
        return last @ _wmat(params["head"], self.dtype), tuple(ks), tuple(vs)

    def decode_logits(self, params, tokens, positions, active, ck, cv):
        """One incremental step over dense per-slot caches: ``tokens``
        [S] (each slot's pending input), ``positions`` [S] (the cache
        index it lands in), ``active`` [S] bool, ``ck``/``cv`` per-layer
        [S, max_len, heads, head_dim], written IN PLACE at each active
        slot's position (inactive slots' rows are rewritten with what they
        held). Attends over the cache masked by per-slot lengths
        (``ops.attention.decode_cache_attention``). Returns logits [S,
        vocab]; inactive slots produce garbage the caller discards."""
        S = tokens.shape[0]
        row = torch.arange(S, device=tokens.device)
        idx = torch.where(active, positions, torch.zeros_like(positions))
        # inactive slots attend over one stale entry instead of an empty
        # set: an all-masked softmax would be NaN
        att_len = torch.where(active, positions + 1,
                              torch.ones_like(positions))
        keep = active[:, None, None]
        x = self._embed(params, tokens) + self._positions(positions)
        for blk, ckl, cvl in zip(params["blocks"], ck, cv):
            h = _layer_norm(x, blk["ln1_s"], blk["ln1_b"])
            q, k, v = self._qkv(blk, h)
            ckl.index_put_((row, idx), torch.where(keep, k, ckl[row, idx]))
            cvl.index_put_((row, idx), torch.where(keep, v, cvl[row, idx]))
            a = decode_cache_attention(q, ckl, cvl, att_len)
            x = x + a.reshape(S, self.dim) @ _wmat(blk["wo"], self.dtype)
            x = self._ffn(blk, x)
        x = _layer_norm(x, params["lnf_s"], params["lnf_b"])
        return x @ _wmat(params["head"], self.dtype)

    # -- paged-cache surface (serving/paged_kv.py). Pools are
    # [num_pages + 1 scratch, page_size, heads, head_dim] per layer and
    # are written IN PLACE; write coordinates are computed on the host
    # (scratch-page redirects for inactive slots and padded positions).
    #
    # QUANTIZED pools (``kv_quant`` a KVQuantConfig) add per-layer fp32
    # scale tensors ``k_scales``/``v_scales`` [num_pages + 1, G, heads]
    # and a host-built write WINDOW (``win_pids``: every page the chunk
    # can land in, ``w_idx``: the window column of each position). The
    # append gathers the window, dequantizes, inserts, grows the touched
    # groups' scales and requantizes (ops.kv_quant.paged_quant_append);
    # pools and scales are then written in place.

    @staticmethod
    def _quant_append(pool, scales, win_pids, w_idx, offs, vals, cfg):
        rows, new = kvq.paged_quant_append(pool, scales, win_pids, w_idx,
                                           offs, vals, cfg)
        kvq.write_window(pool, scales, win_pids, rows, new)

    def _paged_block(self, blk, x, kp, vp, write_pids, write_offs,
                     page_tables, base, ks=None, vs=None, kv_quant=None,
                     win_pids=None, w_idx=None):
        """One block over a chunk of T tokens per slot (the prefill's
        suffix, or a verify chunk): project q/k/v, write k/v into the
        pools at the host-picked (page, offset) ``write_pids`` /
        ``write_offs`` [S, T] (quantized pools: through the window
        ``win_pids`` [S, W] / ``w_idx`` [S, T]), attend over
        ``page_tables`` [S, pages] from ``base`` [S]. ``x`` [S, T, dim];
        returns the new x."""
        h = _layer_norm(x, blk["ln1_s"], blk["ln1_b"])
        q, k, v = self._qkv(blk, h)
        if kv_quant is None:
            kp.index_put_((write_pids, write_offs), k)
            vp.index_put_((write_pids, write_offs), v)
        else:
            for pool, sc, val in ((kp, ks, k), (vp, vs, v)):
                self._quant_append(pool, sc, win_pids, w_idx, write_offs,
                                   val, kv_quant)
        a = paged_chunk_attention(q, kp, vp, page_tables, base, k_scale=ks,
                                  v_scale=vs, quant=kv_quant)
        x = x + a.reshape(x.shape) @ _wmat(blk["wo"], self.dtype)
        return self._ffn(blk, x)

    def _paged_chunk(self, params, x, write_pids, write_offs, page_tables,
                     base, k_pools, v_pools, k_scales, v_scales, kv_quant,
                     win_pids, w_idx):
        """Every block of a paged chunk, then the final layer norm."""
        quant = kv_quant is not None
        for i, (blk, kp, vp) in enumerate(zip(params["blocks"], k_pools,
                                              v_pools)):
            x = self._paged_block(
                blk, x, kp, vp, write_pids, write_offs, page_tables, base,
                ks=k_scales[i] if quant else None,
                vs=v_scales[i] if quant else None, kv_quant=kv_quant,
                win_pids=win_pids, w_idx=w_idx)
        return _layer_norm(x, params["lnf_s"], params["lnf_b"])

    def paged_prefill_logits(self, params, tokens, n, start, write_pids,
                             write_offs, page_table_row, k_pools, v_pools,
                             k_scales=None, v_scales=None, kv_quant=None,
                             win_pids=None, w_idx=None):
        """Prefix-aware paged prefill for ONE slot: run the prompt SUFFIX
        (``tokens`` [bucket], ``n`` true length) at positions ``start ..
        start + bucket - 1``, writing its K/V at ``write_pids`` /
        ``write_offs`` [bucket] (quantized pools: through the window
        ``win_pids`` [W] / ``w_idx`` [bucket]) and attending over
        ``page_table_row`` [window], which already maps any shared-prefix
        pages. Returns the logits [vocab] at the last valid position."""
        L = tokens.shape[0]
        pos = start + torch.arange(L, device=tokens.device)
        x = (self._embed(params, tokens) + self._positions(pos))[None]
        base = torch.full((1,), start, dtype=torch.int64,
                          device=tokens.device)
        quant = kv_quant is not None
        x = self._paged_chunk(
            params, x, write_pids[None], write_offs[None],
            page_table_row[None], base, k_pools, v_pools, k_scales,
            v_scales, kv_quant, win_pids[None] if quant else None,
            w_idx[None] if quant else None)
        return x[0, n - 1] @ _wmat(params["head"], self.dtype)

    def paged_verify_logits(self, params, tokens, base, active, write_pids,
                            write_offs, page_tables, k_pools, v_pools,
                            k_scales=None, v_scales=None, kv_quant=None,
                            win_pids=None, w_idx=None):
        """Speculative-decode verify: score a CHUNK of T tokens per slot
        in one call. ``tokens`` [S, T] (chunk token j sits at cache
        position ``base[s] + j``), ``base`` [S] = valid cache length
        before the chunk, ``write_pids``/``write_offs`` [S, T] (quantized
        pools: the window ``win_pids`` [S, W] / ``w_idx`` [S, T]).
        Returns logits [S, T, vocab]: logits[:, j] is the distribution
        after chunk token j, so greedy targets verify the drafts
        positionally."""
        T = tokens.shape[1]
        pos = base[:, None] + torch.arange(T, device=tokens.device)[None]
        x = self._embed(params, tokens) + self._positions(pos)
        safe_base = torch.where(active, base, torch.zeros_like(base))
        x = self._paged_chunk(params, x, write_pids, write_offs,
                              page_tables, safe_base, k_pools, v_pools,
                              k_scales, v_scales, kv_quant, win_pids, w_idx)
        return x @ _wmat(params["head"], self.dtype)

    def paged_decode_logits(self, params, tokens, positions, active,
                            write_pids, write_offs, page_tables, k_pools,
                            v_pools, k_scales=None, v_scales=None,
                            kv_quant=None):
        """One paged incremental step: ``tokens`` [S] (each slot's pending
        input), ``positions`` [S] (the cache index it lands in), ``active``
        [S] bool, ``write_pids``/``write_offs`` [S] (scratch page for
        inactive slots), ``page_tables`` [S, max_pages] int32. Appends
        K/V in place (quantized pools: the write window is the one
        written page of each slot) and attends through K3 or K3-quant.
        Returns logits [S, vocab]; inactive slots attend over one stale
        entry and produce garbage the caller discards."""
        att_len = torch.where(active, positions + 1,
                              torch.ones_like(positions)).to(torch.int32)
        x = self._embed(params, tokens) + self._positions(positions)
        if kv_quant is not None:
            win = write_pids[:, None]
            w_idx = torch.zeros_like(win)
            offs = write_offs[:, None]
        for i, (blk, kp, vp) in enumerate(zip(params["blocks"], k_pools,
                                              v_pools)):
            h = _layer_norm(x, blk["ln1_s"], blk["ln1_b"])
            q, k, v = self._qkv(blk, h)
            ks = vs = None
            if kv_quant is None:
                kp.index_put_((write_pids, write_offs), k)
                vp.index_put_((write_pids, write_offs), v)
            else:
                ks, vs = k_scales[i], v_scales[i]
                for pool, sc, val in ((kp, ks, k), (vp, vs, v)):
                    self._quant_append(pool, sc, win, w_idx, offs,
                                       val[:, None], kv_quant)
            a = paged_attention.paged_decode_attention(
                q, kp, vp, page_tables, att_len, k_scale=ks, v_scale=vs,
                quant=kv_quant)
            x = x + a.reshape(x.shape) @ _wmat(blk["wo"], self.dtype)
            x = self._ffn(blk, x)
        x = _layer_norm(x, params["lnf_s"], params["lnf_b"])
        return x @ _wmat(params["head"], self.dtype)


def save_decoder(path, model, params):
    """Persist a model + params as ``config.json`` + ``params.npz`` under
    ``path`` — the reference's on-disk form. Arrays are written as
    float32 (numpy has no bfloat16; the cast is exact) and ``dtype`` in
    the config names the model dtype, so either package loads it."""
    os.makedirs(path, exist_ok=True)
    inv = {v: k for k, v in _DTYPES.items()}
    cfg = {"vocab_size": model.vocab_size, "dim": model.dim,
           "n_heads": model.n_heads, "n_layers": model.n_layers,
           "ffn_mult": model.ffn_dim / model.dim,
           "dtype": inv[model.dtype]}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)

    def arr(t):
        return t.detach().to(device="cpu", dtype=torch.float32).numpy()

    flat = {}
    for key, value in params.items():
        if key == "blocks":
            for i, blk in enumerate(value):
                for name, t in blk.items():
                    flat["blocks.%d.%s" % (i, name)] = arr(t)
        else:
            flat[key] = arr(value)
    np.savez(os.path.join(path, "params.npz"), **flat)


# the decoder's 2-D matrices: what weight-only quantization covers (layer
# norm scales and shifts and the biases stay full precision)
_QUANTIZABLE_WEIGHTS = frozenset(
    ("wq", "wk", "wv", "wo", "w1", "w2", "embed", "head"))


def quantize_decoder_dir(src_dir, dst_dir, mode):
    """Publish-time weight-only quantization of a ``save_decoder``
    directory (either package's): quantize every 2-D matrix per output
    channel, write ``<dst>/params.npz`` with ``<name>.qw`` and
    ``<name>.scale`` pairs and ``<dst>/config.json`` with a
    ``weight_quant`` stanza, so :func:`load_decoder` (either package's)
    rebuilds a dequant-on-use model. fp8 payloads are stored as uint8
    views, as the reference stores them. ``mode`` is ``"int8"`` or
    ``"fp8"``. Sidecar files are copied. Returns the stanza."""
    if mode not in kvq.WEIGHT_QUANT_DTYPES or mode == "off":
        raise ValueError("quantize_decoder_dir mode must be fp8|int8 (got "
                         "%r)" % (mode,))
    cfg_path = os.path.join(src_dir, "config.json")
    if not os.path.isfile(cfg_path):
        raise ValueError(
            "%s is not a saved decoder (missing config.json) — weight-only "
            "quantization applies to save_decoder artifacts" % src_dir)
    with open(cfg_path) as f:
        cfg = json.load(f)
    if cfg.get("weight_quant"):
        raise ValueError(
            "%s is already weight-quantized (%r) — re-quantizing a "
            "quantized artifact would compound the rounding"
            % (src_dir, cfg["weight_quant"]))
    flat = {}
    with np.load(os.path.join(src_dir, "params.npz")) as npz:
        for key in npz.files:
            arr = npz[key]
            if key.split(".")[-1] in _QUANTIZABLE_WEIGHTS:
                # bf16 arrays (void records) widen exactly to fp32
                qw, scale = kvq.quantize_weight(
                    array_to_tensor(arr, torch.float32), mode)
                if qw.dtype != torch.int8:
                    qw = qw.view(torch.uint8)
                flat[key + ".qw"] = qw.numpy()
                flat[key + ".scale"] = scale.numpy()
            else:
                flat[key] = arr
    stanza = {"dtype": mode, "scheme": "per_output_channel"}
    cfg["weight_quant"] = stanza
    os.makedirs(dst_dir, exist_ok=True)
    with open(os.path.join(dst_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    np.savez(os.path.join(dst_dir, "params.npz"), **flat)
    for fn in sorted(os.listdir(src_dir)):
        src = os.path.join(src_dir, fn)
        if fn in ("config.json", "params.npz", "_MANIFEST") or \
                not os.path.isfile(src):
            continue
        shutil.copyfile(src, os.path.join(dst_dir, fn))
    catalog.WEIGHT_QUANT_ARTIFACTS.inc()
    return stanza


def load_decoder(path, device=None):
    """Inverse of :func:`save_decoder` and :func:`quantize_decoder_dir`
    (and of the JAX package's): returns ``(model, params)`` with params
    on ``device`` in the config's dtype, checked complete against the
    config's layer count. A ``weight_quant`` stanza rebuilds ``{"qw",
    "scale"}`` leaves (payload in the storage dtype, fp32 scales) that
    the model dequantizes before each matmul; ``model.weight_quant``
    carries the mode (None at full precision)."""
    dev = resolve_device(device)
    cfg_path = os.path.join(path, "config.json")
    if not os.path.isfile(cfg_path):
        raise ValueError("%s is not a saved decoder (missing config.json)"
                         % path)
    with open(cfg_path) as f:
        cfg = json.load(f)
    wq_mode = (cfg.pop("weight_quant", None) or {}).get("dtype")
    if wq_mode is not None and wq_mode not in ("int8", "fp8"):
        raise ValueError("config.json weight_quant dtype %r is not fp8|int8"
                         % (wq_mode,))
    name = cfg.pop("dtype", "float32")
    if name not in _DTYPES:
        raise ValueError("config.json dtype %r is not one of %s"
                         % (name, "|".join(_DTYPES)))
    model = TransformerDecoderModel(dtype=_DTYPES[name], **cfg)
    model.weight_quant = wq_mode

    def leaf(key, raw):
        part = key.split(".")[-1]
        if part == "qw":
            if wq_mode is None:
                raise ValueError(
                    "params.npz carries quantized weight %r but config.json "
                    "has no weight_quant stanza" % key)
            return quant_payload_to_tensor(raw, wq_mode, dev)
        if part == "scale":
            return array_to_tensor(raw, torch.float32, dev)
        return array_to_tensor(raw, model.dtype, dev)

    def assign(container, pname, t):
        if "." in pname:   # "<weight>.qw" / "<weight>.scale"
            wname, part = pname.split(".", 1)
            container.setdefault(wname, {})[part] = t
        else:
            container[pname] = t

    blocks = [{} for _ in range(model.n_layers)]
    params = {"blocks": blocks}
    with np.load(os.path.join(path, "params.npz")) as npz:
        for key in npz.files:
            t = leaf(key, npz[key])
            if key.startswith("blocks."):
                _, idx, pname = key.split(".", 2)
                if int(idx) >= model.n_layers:
                    raise ValueError(
                        "params.npz names layer %s but config.json "
                        "declares n_layers=%d" % (idx, model.n_layers))
                assign(blocks[int(idx)], pname, t)
            else:
                assign(params, key, t)

    def complete(v):   # a quantized leaf needs both halves
        return not isinstance(v, dict) or ("qw" in v and "scale" in v)

    missing = ["blocks.%d.%s" % (i, k) for i, blk in enumerate(blocks)
               for k in _BLOCK_KEYS if k not in blk or not complete(blk[k])]
    missing += [k for k in ("embed", "head", "lnf_s", "lnf_b")
                if k not in params or not complete(params[k])]
    if missing:
        raise ValueError("params.npz is missing parameters: %s"
                         % ", ".join(missing))
    return model, params


# ---------------------------------------------------------------------------
# Engine plumbing and reference decode loops
# ---------------------------------------------------------------------------


class _EngineBase:
    """Failure plumbing for engines that update their pools in place: a
    failed call may have written part of a step, so the engine is marked
    dead and raises :class:`DeviceStateError` until reset."""

    def _check_live(self):
        if self._dead:
            raise DeviceStateError(
                "engine cache buffers were lost by an earlier failed "
                "call — reset() before further use")

    def _guarded(self, fn, *args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            self._dead = True
            raise DeviceStateError(
                "a call that updates the KV pools in place failed (%s: %s) "
                "— engine state unknown, reset() required"
                % (type(e).__name__, e)) from e


def draw_tokens(logits, temperatures, seed, step, greedy=None):
    """Temperature draws that are a pure function of ``(seed, step, slot,
    token)``: a Gumbel-max draw from ``softmax(logits / t)`` whose
    uniforms come from a counter hash, so step ``step`` of any schedule
    (one step at a time, or trip ``step - step0`` of a megastep) draws
    the same tokens, and a CUDA graph can replay it. ``temperatures`` is
    a device tensor [S]; ``seed`` and ``step`` are ints or int64 device
    tensors of one element. Slots at temperature <= 0 take ``greedy``
    (argmax of the logits when not given)."""
    S, V = logits.shape
    dev = logits.device
    if greedy is None:
        greedy = torch.argmax(logits, dim=-1)
    key = _mix32(_mix32(seed & _M32) ^ (step & _M32))
    slot_key = _mix32(key ^ torch.arange(S, device=dev))       # [S]
    token_key = _mix32((torch.arange(V, device=dev) + 0x9E3779B9) & _M32)
    bits = _mix32(slot_key[:, None] ^ token_key[None, :]) >> 8  # 24 bits
    u = (bits.float() + 0.5) * (1.0 / (1 << 24))               # (0, 1)
    gumbel = -torch.log(-torch.log(u))
    hot = temperatures > 0
    safe_t = torch.where(hot, temperatures, torch.ones_like(temperatures))
    sampled = torch.argmax(logits.float() / safe_t[:, None] + gumbel,
                           dim=-1)
    return torch.where(hot, sampled, greedy)


def sample_tokens(logits, temperatures, seed=0, step=0):
    """Next tokens from ``logits`` [S, V] (on the device): argmax where
    ``temperatures`` (host array [S]) is <= 0, else :func:`draw_tokens`'
    draw for ``(seed, step)``. Draws nothing when no slot samples.
    Returns a device tensor."""
    greedy = torch.argmax(logits, dim=-1)
    temps = np.asarray(temperatures, np.float32)
    if not (temps > 0).any():
        return greedy
    return draw_tokens(logits, torch.from_numpy(temps).to(logits.device),
                       int(seed), int(step), greedy)


class DecodeEngine(_EngineBase):
    """Slot-managed dense KV-cache decode engine over one model + params:
    per-layer K/V caches of fixed shape ``[max_slots, max_len, heads,
    head_dim]`` on the engine's device, plus host bookkeeping (lengths,
    active mask, each slot's pending input token). The serving engine
    when no paged one is asked for, and the draft engine of speculative
    decoding (its ``lengths`` are rewound past rejected drafts; the stale
    rows stay until overwritten, masked by the lengths).

    - ``prefill(slot, prompt)`` runs the prompt once at its bucket
      through the full forward and writes the slot's cache rows;
    - ``decode_step(temperatures, seed, step)`` advances every active
      slot by one token (attention through
      ``ops.attention.decode_cache_attention``, plain PyTorch as the
      reference computes it outside any Pallas kernel), greedy or drawn
      as :func:`draw_tokens` draws.

    ``device`` defaults to ``"cuda"`` and raises without a GPU; pass
    ``"cpu"`` to run on the CPU. NOT thread-safe: one thread owns it."""

    def __init__(self, model, params, *, max_slots=None, max_len=None,
                 prefill_buckets=None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.params = params_to_device(params, self.device)
        self.max_slots, self.max_len, self.prefill_buckets = \
            resolve_generation_knobs(max_slots, max_len, prefill_buckets)
        self.max_prompt_len = self.prefill_buckets[-1]
        S = self.max_slots
        self._cache_shape = (S, self.max_len, model.n_heads, model.head_dim)
        self.lengths = np.zeros(S, np.int64)     # tokens cached per slot
        self.active = np.zeros(S, bool)
        self._in_tokens = np.zeros(S, np.int32)  # next step's input token
        self.reset()

    def reset(self):
        """(Re)allocate zeroed caches and clear every slot — required
        after :class:`DeviceStateError`, harmless otherwise."""
        def zeros():
            return [torch.zeros(self._cache_shape, dtype=self.model.dtype,
                                device=self.device)
                    for _ in range(self.model.n_layers)]
        self._ck, self._cv = zeros(), zeros()
        self.lengths[:] = 0
        self.active[:] = False
        self._in_tokens[:] = 0
        self._dead = False

    def _tensor(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def free_slots(self):
        return [s for s in range(self.max_slots) if not self.active[s]]

    def _prefill_run(self, buf, n, slot):
        logits, ks, vs = self.model.last_logits_and_kv(
            self.params, self._tensor(buf)[None],
            torch.full((1,), n, dtype=torch.int64, device=self.device))
        L = buf.size
        for c, k in zip(self._ck, ks):
            c[slot, :L] = k[0]
        for c, v in zip(self._cv, vs):
            c[slot, :L] = v[0]
        return logits[0].float().cpu().numpy()

    @torch.no_grad()
    def prefill(self, slot, prompt):
        """Run ``prompt`` once at its bucketed length, writing slot
        ``slot``'s cache rows (the padded tail's rows are garbage past
        the slot's length); returns the last position's logits (np.float32
        [vocab]). The slot becomes active with ``lengths[slot] =
        len(prompt)``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n = prompt.size
        if n < 1:
            raise ValueError("prompt must contain at least one token")
        if n > self.max_prompt_len:
            raise ValueError(
                "prompt length %d exceeds the largest usable prefill "
                "bucket %d (FLAGS_generation_prefill_buckets=%s within "
                "FLAGS_generation_max_len=%d)"
                % (n, self.max_prompt_len, list(self.prefill_buckets),
                   self.max_len))
        if prompt.min() < 0 or prompt.max() >= self.model.vocab_size:
            raise ValueError("prompt token ids must be in [0, %d)"
                             % self.model.vocab_size)
        if self.active[slot]:
            raise RuntimeError("slot %d is already active" % slot)
        self._check_live()
        bucket = next(b for b in self.prefill_buckets if b >= n)
        buf = np.zeros(bucket, np.int32)
        buf[:n] = prompt
        with tracing.span("engine.prefill", slot=int(slot),
                          bucket=int(bucket), n_prompt=int(n)):
            logits = self._guarded(self._prefill_run, buf, int(n),
                                   int(slot))
        self.lengths[slot] = n
        self.active[slot] = True
        return logits

    def set_input_token(self, slot, token):
        """The token the next decode step consumes for ``slot``."""
        self._in_tokens[slot] = np.int32(token)

    @torch.no_grad()
    def decode_step(self, temperatures=None, seed=0, step=0):
        """Advance every active slot by one token: greedy where the
        slot's temperature is <= 0, else drawn under ``(seed, step)``
        (:func:`draw_tokens`). Returns the tokens (np.int32 [max_slots];
        inactive slots' entries are garbage)."""
        if not self.active.any():
            raise RuntimeError("decode_step with no active slots")
        if (self.lengths[self.active] >= self.max_len).any():
            raise RuntimeError(
                "an active slot is at KV-cache capacity "
                "(generation_max_len=%d) — evict it first" % self.max_len)
        self._check_live()
        temps = np.zeros(self.max_slots, np.float32) \
            if temperatures is None else np.asarray(temperatures, np.float32)

        def run():
            logits = self.model.decode_logits(
                self.params, self._tensor(self._in_tokens),
                self._tensor(self.lengths), self._tensor(self.active),
                self._ck, self._cv)
            return sample_tokens(logits, temps, seed, step).cpu().numpy()

        toks = self._guarded(run).astype(np.int32)
        self.lengths[self.active] += 1
        self._in_tokens = np.where(self.active, toks,
                                   self._in_tokens).astype(np.int32)
        return toks

    def release(self, slot):
        """Evict a finished sequence; the slot is reusable at once (its
        stale rows are masked by the next occupant's length)."""
        self.active[slot] = False
        self.lengths[slot] = 0
        self._in_tokens[slot] = 0


def greedy_generate(engine, prompts, max_new_tokens, *, eos_id=None):
    """Synchronous greedy decode of up to ``engine.max_slots`` prompts on
    the calling thread — the no-scheduler reference path, over a dense
    :class:`DecodeEngine` or a paged engine (which reserves each
    request's worst case). ``max_new_tokens``: int or per-prompt list.
    Returns a list of generated-token lists (capped by cache
    capacity)."""
    if engine.active.any():
        raise RuntimeError("engine has active slots")
    if len(prompts) > engine.max_slots:
        raise ValueError("%d prompts > max_slots=%d"
                         % (len(prompts), engine.max_slots))
    budgets = [int(m) for m in (max_new_tokens if
                                isinstance(max_new_tokens, (list, tuple))
                                else [max_new_tokens] * len(prompts))]
    outs = [[] for _ in prompts]
    live = {}
    paged = hasattr(engine, "page_size")
    for i, prompt in enumerate(prompts):
        if paged:   # reserve this request's worst case, not max_len
            logits = engine.prefill(i, prompt, max_new_tokens=budgets[i])
        else:
            logits = engine.prefill(i, prompt)
        budgets[i] = min(budgets[i], engine.max_len - int(engine.lengths[i]))
        tok = int(np.argmax(logits))
        outs[i].append(tok)
        if (eos_id is not None and tok == eos_id) or \
                len(outs[i]) >= budgets[i]:
            engine.release(i)
        else:
            engine.set_input_token(i, tok)
            live[i] = True
    while engine.active.any():
        toks = engine.decode_step()
        for i in list(live):
            tok = int(toks[i])
            outs[i].append(tok)
            if (eos_id is not None and tok == eos_id) or \
                    len(outs[i]) >= budgets[i] or \
                    engine.lengths[i] >= engine.max_len:
                engine.release(i)
                del live[i]
    return outs


@torch.no_grad()
def full_recompute_generate(model, params, prompts, max_new_tokens, *,
                            eos_id=None, max_len=None):
    """The O(T²)-per-sequence baseline: greedy decode that re-runs the
    FULL forward over every prefix for each emitted token, at the static
    ``[batch, max_len]`` shape, on the device the params live on.
    Returns a list of generated-token lists."""
    from .. import flags
    if max_len is None:
        max_len = int(flags.generation_max_len)
    device = params["lnf_s"].device   # a leaf that is never quantized
    B = len(prompts)
    buf = np.zeros((B, max_len), np.int32)
    lengths = np.zeros(B, np.int64)
    budgets = [int(m) for m in (max_new_tokens if
                                isinstance(max_new_tokens, (list, tuple))
                                else [max_new_tokens] * B)]
    for i, p in enumerate(prompts):
        p = np.asarray(p, np.int32).reshape(-1)
        if not 1 <= p.size <= max_len - 1:
            raise ValueError("prompt %d length %d not in [1, %d]"
                             % (i, p.size, max_len - 1))
        buf[i, :p.size] = p
        lengths[i] = p.size
        budgets[i] = min(budgets[i], max_len - p.size)
    outs = [[] for _ in range(B)]
    done = np.zeros(B, bool)
    while not done.all():
        logits, _, _ = model.last_logits_and_kv(
            params, torch.from_numpy(buf).to(device),
            torch.from_numpy(lengths).to(device), need_kv=False)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i in range(B):
            if done[i]:
                continue
            tok = int(nxt[i])
            outs[i].append(tok)
            if lengths[i] < max_len:
                buf[i, lengths[i]] = tok
            lengths[i] += 1
            if (eos_id is not None and tok == eos_id) or \
                    len(outs[i]) >= budgets[i] or lengths[i] >= max_len:
                done[i] = True
    return outs


# ---------------------------------------------------------------------------
# Brownout load shedding
# ---------------------------------------------------------------------------


class BrownoutController:
    """Watermark-driven brownout ladder with hysteresis.

    ``update(pressure)`` takes the saturation signal — ``max(queue
    fullness, KV page-pool occupancy)`` in [0, 1], or 1.0 under a
    sustained high-class SLO violation — and moves the LEVEL one step at
    a time:

      =====  ======================================================
      level  degradation in force
      =====  ======================================================
      0      normal service
      1      speculative decoding disabled (draft compute returned
             to the target model)
      2      ...and new admissions' token budgets clamped to
             ``FLAGS_shed_token_cap``
      3      ...and low-priority requests shed with a drain-rate
             Retry-After (503)
      =====  ======================================================

    Pressure >= ``high`` escalates (at most once per ``dwell_s``, so a
    single spiky evaluation cannot jump straight to shedding); pressure
    <= ``low`` de-escalates on the same dwell; between the watermarks the
    level holds. ``clock`` (default ``time.monotonic``) is injectable.
    Thread-safe: the scheduler loop and every submitting thread update
    it. Level changes are recorded as ``shed.brownout`` spans."""

    MAX_LEVEL = 3

    def __init__(self, high=None, low=None, dwell_s=0.25, clock=None):
        from .registry import resolve_fleet_knobs
        knobs = resolve_fleet_knobs(
            shed_high_watermark=high, shed_low_watermark=low,
            which=("shed_high_watermark", "shed_low_watermark"))
        self.high = knobs["shed_high_watermark"]
        self.low = knobs["shed_low_watermark"]
        self.dwell_s = float(dwell_s)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._level = 0             # guarded-by: _lock
        self._last_change = -1e30   # guarded-by: _lock

    def level(self):
        with self._lock:
            return self._level

    def update(self, pressure):
        """Fold one pressure observation in; returns the (possibly
        changed) level."""
        pressure = float(pressure)
        with self._lock:
            now = self._clock()
            new = self._level
            if now - self._last_change >= self.dwell_s:
                if pressure >= self.high and self._level < self.MAX_LEVEL:
                    new = self._level + 1
                elif pressure <= self.low and self._level > 0:
                    new = self._level - 1
            changed = new != self._level
            if changed:
                self._level = new
                self._last_change = now
        if changed:
            tracing.record("shed.brownout", level=new,
                           pressure=round(pressure, 4))
        return new


# ---------------------------------------------------------------------------
# Continuous-batching scheduler
# ---------------------------------------------------------------------------


class _STOP:
    pass


class _SlotState:
    __slots__ = ("pending", "prompt", "prompt_len", "budget", "temperature",
                 "generated", "t_first", "t_last", "decode_steps",
                 "spec_rounds", "spec_accepted", "hold_ms", "prefill_stats")

    def __init__(self, pending, prompt, budget, temperature):
        self.pending = pending
        self.prompt = prompt      # a preempted request resumes from it
        self.prompt_len = int(prompt.size)
        self.budget = budget
        self.temperature = temperature
        self.generated = []
        self.t_first = None       # perf stamp of the first token (TTFT)
        self.t_last = None        # perf stamp of the newest token (TPOT)
        self.decode_steps = 0     # decode / verify steps this request rode
        self.spec_rounds = 0
        self.spec_accepted = 0
        self.hold_ms = 0.0        # admission hold (held lane)
        self.prefill_stats = None


class GenerationScheduler:
    """Iteration-level (continuous) batching over a dense
    :class:`DecodeEngine` or a :class:`~.paged_kv.PagedDecodeEngine`.

    ``submit(prompt, ...)`` → :class:`PendingResult` resolving to
    ``{"tokens": [...], "finish_reason": "eos"|"length", "n_prompt": n,
    "slo": {...}}``. A loop thread owns the engine: between decode steps
    it admits queued requests into free slots (prefill) and evicts
    finished sequences. Admission is bounded (``queue_depth``, default
    ``FLAGS_serving_queue_depth``): a full queue raises
    :class:`OverloadedError` (HTTP 503). A paged engine switches
    admission to free-page accounting: a request leaves the queue only
    when the pool (plus evictable prefix-cache pages) covers its worst
    case; until then it is PARKED on the held lane while decoding
    continues. A request that could never fit the pool is rejected at
    ``submit`` (ValueError → HTTP 400).

    Deadlines (``deadline_ms``, from ``X-Deadline-Ms``, defaulting to
    ``FLAGS_deadline_default_ms``): a request dead on arrival is 504'd
    before any prefill; an in-flight slot past its deadline is evicted
    between decode steps.

    Brownout (:class:`BrownoutController`, fed by :meth:`_pressure` from
    submitting threads and the loop): level 1 turns speculation off,
    level 2 clamps new admissions' budgets to ``FLAGS_shed_token_cap``,
    level 3 sheds ``priority="low"`` submissions with a drain-rate
    Retry-After (``requests_shed_total``).

    Tenants and the held lane: each request carries a ``priority``
    ("high"/"low") and a ``tenant`` (``X-Tenant-Id``). A tenant over its
    token budget in the current window (``FLAGS_tenant_token_budget*``)
    is throttled to the held lane — its in-flight greedy slots are
    preempted there between steps (full KV pages parked in the prefix
    cache, so the re-admission prefill recomputes only the suffix and
    the stream resumes token-identically) — never 503'd. The lane
    (``FLAGS_tenant_held_depth``) drains high class before low, FIFO
    within a class; a budget block is per tenant, a page block holds its
    class. Page pressure against a high-class admission preempts
    low-class work. The SLO loop compares live TTFT/TPOT with
    ``FLAGS_slo_*_ms``; a high-class violation sustained past
    ``FLAGS_slo_sustain_s`` pins brownout pressure to 1, clamps the
    megastep K to 1 and preempts one low-class victim an iteration.

    Greedy requests (temperature 0) are deterministic and independent of
    co-scheduling; sampled ones draw under ``(seed, decode step, slot)``
    (:func:`draw_tokens`), first tokens under steps -1, -2, ... in
    admission order.

    Speculative decoding (``draft_engine``, a dense engine over the
    draft model, with ``engine.speculative_k`` >= 1): all-greedy decode
    batches run :func:`~.paged_kv.speculative_round` (up to k tokens per
    verify step, token-identical to plain greedy); a sampled co-rider, a
    chunk that no longer fits, or brownout falls the batch back to a
    synced plain step (``speculative_fallback_total{reason}``). A draft
    engine forces the megastep K to 1.

    Megastep decoding (``engine.megastep_k`` > 1, no draft): each
    iteration dispatches up to K decode trips at once
    (:meth:`~.paged_kv.PagedDecodeEngine.megastep_dispatch`), K clamped
    by the widest remaining budget, the tightest deadline's slack and SLO
    pressure (:meth:`_clamp_k`); when no admission work waits, megastep
    N+1 is dispatched from N's device outputs before N is synced
    (:meth:`_ms_can_chain`). Trip t draws as step ``step0 + t`` would,
    so the streams are those of the step-at-a-time loop (K = 1).
    ``close()`` drains: no new admissions, every queued, held and
    in-flight sequence decodes to its natural finish, then the loop
    exits.
    """

    def __init__(self, engine, *, eos_id=None, queue_depth=None,
                 default_max_new_tokens=64, seed=0, draft_engine=None,
                 brownout=None, tenant_token_budget=None,
                 tenant_token_budget_map=None, tenant_budget_window_s=None,
                 tenant_held_depth=None, slo_ttft_ms=None, slo_tpot_ms=None,
                 slo_sustain_s=None):
        from .registry import resolve_fleet_knobs
        depth = resolve_serving_knobs(queue_depth=queue_depth,
                                      which=("queue_depth",))[2]
        knobs = resolve_fleet_knobs(which=(
            "deadline_default_ms", "deadline_admit_min_ms",
            "shed_token_cap", "shed_retry_floor_s", "shed_retry_cap_s"))
        self._deadline_default_s = knobs["deadline_default_ms"] / 1e3
        self._admit_min_s = knobs["deadline_admit_min_ms"] / 1e3
        self._shed_token_cap = knobs["shed_token_cap"]
        self.drain_rate = DrainRateEstimator(knobs["shed_retry_floor_s"],
                                             knobs["shed_retry_cap_s"])
        self.brownout = brownout if brownout is not None \
            else BrownoutController()
        self.engine = engine
        self.device = engine.device
        self._paged = hasattr(engine, "page_size")
        self._draft = draft_engine
        self._spec_k = int(getattr(engine, "speculative_k", 0))
        if self._spec_k >= 1 and draft_engine is None:
            raise ValueError(
                "FLAGS_speculative_k=%d requires a draft engine (serve "
                "--gen-draft-model)" % self._spec_k)
        if draft_engine is not None:
            if self._spec_k < 1:
                raise ValueError("a draft engine is pointless with FLAGS_"
                                 "speculative_k=0 — set it >= 1")
            from .paged_kv import validate_draft_geometry
            validate_draft_geometry(engine, draft_engine)
        self.eos_id = eos_id
        self.default_max_new_tokens = int(default_max_new_tokens)
        self._seed = int(seed)
        self._first_draws = 0
        self._tenant = resolve_tenant_knobs(
            token_budget=tenant_token_budget,
            token_budget_map=tenant_token_budget_map,
            budget_window_s=tenant_budget_window_s,
            held_depth=tenant_held_depth, slo_ttft_ms=slo_ttft_ms,
            slo_tpot_ms=slo_tpot_ms, slo_sustain_s=slo_sustain_s)
        self._slo_ttft = self._tenant["slo_ttft_ms"]
        self._slo_tpot = self._tenant["slo_tpot_ms"]
        self._held_q = []          # the held lane (loop-private)
        self._tenant_used = {}     # tenant -> tokens this window
        self._tenant_window_t0 = time.perf_counter()
        self._slo_bad_since = {}   # class -> violation onset stamp
        self._slo_last_check = time.perf_counter()
        self._slo_pressed = False  # sustained high-class violation
        # a draft engine keeps the step-at-a-time path: a speculative
        # round is its own multi-token step, and its plain fallback must
        # step the draft cache token by token
        self._megastep_k = int(getattr(engine, "megastep_k", 1)) \
            if draft_engine is None else 1
        self._ms_inflight = None     # a chained megastep not yet synced
        self._last_result_t = None   # when the last decode result landed
        self._step_ewma_s = None     # observed wall seconds per trip
        self._snap = None            # this iteration's admission snapshot
        self._q = queue.Queue(maxsize=depth)
        self._step_idx = 0
        self._n_active = 0
        self._closed = False
        self._admit_lock = threading.Lock()
        self._close_lock = threading.Lock()
        self._drained = threading.Event()
        self._loop_thread = threading.Thread(
            target=self._loop, name="generation-scheduler", daemon=True)
        self._loop_thread.start()

    # -- client surface ------------------------------------------------
    def _pressure(self):
        """The brownout ladder's saturation signal: the max of queue
        fullness and (paged) page-pool occupancy, or 1.0 while a
        high-class SLO violation is sustained."""
        if self._slo_pressed:
            return 1.0
        depth = self._q.maxsize
        p = (self._q.qsize() / float(depth)) if depth else 0.0
        if self._paged:
            st = self.engine.page_stats()
            if st["kv_pages_total"]:
                p = max(p, st["kv_pages_in_use"] /
                        float(st["kv_pages_total"]))
        return min(1.0, p)

    def brownout_level(self):
        """Current shed-ladder level (the ``brownout_level`` gauge)."""
        return self.brownout.level()

    def retry_after_hint(self):
        """Drain-rate-derived Retry-After (seconds) for the backlog."""
        return self.drain_rate.retry_after(self._q.qsize() + self._n_active)

    def submit(self, prompt, max_new_tokens=None, temperature=0.0,
               trace=None, deadline_ms=None, priority="high", tenant=None):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        budget = int(self.default_max_new_tokens if max_new_tokens is None
                     else max_new_tokens)
        if budget < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if priority not in PRIORITY_CLASSES:
            raise ValueError("priority must be 'high' or 'low' (got %r)"
                             % (priority,))
        temperature = float(temperature)
        if not (np.isfinite(temperature) and temperature >= 0):
            raise ValueError("temperature must be finite and >= 0 (got %r)"
                             % temperature)
        if self._paged and not self.engine.fits_ever(prompt.size, budget):
            # a permanent misfit is a client error (400), not overload
            raise ValueError(
                "request worst case (prompt %d + max_new_tokens %d at "
                "FLAGS_kv_page_size=%d) exceeds the page pool "
                "(FLAGS_kv_num_pages=%d)"
                % (prompt.size, budget, self.engine.page_size,
                   self.engine.num_pages))
        # submitting threads fold pressure in too, so the ladder moves
        # while the loop blocks idle; level-3 shedding happens here,
        # before the queue and before any compute
        level = self.brownout.update(self._pressure())
        if level >= 3 and priority == "low":
            catalog.REQUESTS_SHED.inc(**{"class": priority})
            err = OverloadedError(
                "brownout level %d: low-priority request shed — retry "
                "after the backlog drains" % level)
            err.retry_after = self.retry_after_hint()
            raise err
        pending = PendingResult(trace=trace)
        pending.priority = priority
        pending.tenant = tenant if tenant is None else str(tenant)
        if deadline_ms is None and self._deadline_default_s > 0:
            deadline_ms = self._deadline_default_s * 1e3
        if deadline_ms is not None:
            pending.deadline = pending.t_enqueue + \
                max(0.0, float(deadline_ms)) / 1e3
        req = (pending, prompt, budget, temperature)
        with self._admit_lock:
            if self._closed:
                raise ServingClosedError("generation is shut down")
            try:
                self._q.put_nowait(req)
            except queue.Full:
                catalog.GENERATION_REJECTED.inc()
                err = OverloadedError(
                    "generation queue full (depth %d) — retry later"
                    % self._q.maxsize)
                err.retry_after = self.retry_after_hint()
                raise err from None
        catalog.GENERATION_REQUESTS.inc()
        return pending

    def generate(self, prompt, max_new_tokens=None, temperature=0.0,
                 timeout=None, trace=None, deadline_ms=None,
                 priority="high", tenant=None):
        """Blocking submit → wait."""
        return self.submit(prompt, max_new_tokens, temperature, trace=trace,
                           deadline_ms=deadline_ms, priority=priority,
                           tenant=tenant).wait(timeout)

    def queue_depth(self):
        return self._q.qsize()

    def active_slots(self):
        """Slots currently decoding (the live /metrics gauge)."""
        return self._n_active

    def held_depth(self):
        """Requests parked in the held lane (the
        ``generation_held_requests`` gauge)."""
        return len(self._held_q)

    def residue(self):
        """Work still in flight: queued, held and decoding requests."""
        return {"queued": self._q.qsize(), "held": self.held_depth(),
                "active_slots": self._n_active}

    def close(self, timeout=None):
        """Graceful drain: stop admitting, decode every queued, held and
        in-flight sequence to its finish, stop the loop. Returns True
        when drained, False when ``timeout`` expired (call again to
        finish the join)."""
        with self._close_lock:
            if self._drained.is_set():
                return True
            if not self._closed:
                with self._admit_lock:
                    self._closed = True
                self._q.put(_STOP)   # lands BEHIND every admitted request
            self._loop_thread.join(timeout)
            if self._loop_thread.is_alive():
                return False
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not _STOP:
                    item[0]._fail(ServingClosedError("generation shut down"))
            self._drained.set()
            return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- loop thread ---------------------------------------------------
    def _sample_first(self, logits, temperature):
        """First token from the prefill logits (host array [vocab]); the
        n-th sampled first token draws under step -n."""
        if temperature <= 0:
            return int(np.argmax(logits))
        self._first_draws += 1
        t = torch.from_numpy(np.asarray(logits, np.float32))[None]
        return int(sample_tokens(t.to(self.device), [temperature],
                                 self._seed, -self._first_draws)[0])

    def _slo_summary(self, state, reason):
        """TTFT = submit → first token; TPOT = mean inter-token latency
        after the first token."""
        pending = state.pending
        n = len(state.generated)
        summary = {"outcome": reason, "tokens": n,
                   "decode_steps": state.decode_steps,
                   "latency_ms": round(
                       (time.perf_counter() - pending.t_enqueue) * 1e3, 3)}
        if state.hold_ms:
            summary["hold_ms"] = round(state.hold_ms, 3)
        if state.t_first is not None:
            ttft = state.t_first - pending.t_enqueue
            summary["ttft_ms"] = round(ttft * 1e3, 3)
            catalog.REQUEST_TTFT_SECONDS.observe(ttft)
        if n >= 2 and state.t_first is not None and state.t_last is not None:
            tpot = (state.t_last - state.t_first) / (n - 1)
            summary["tpot_ms"] = round(tpot * 1e3, 3)
            catalog.REQUEST_TPOT_SECONDS.observe(tpot)
        if state.spec_rounds:
            summary["spec_rounds"] = state.spec_rounds
            summary["spec_accepted"] = state.spec_accepted
        if state.prefill_stats:
            # imported_pages > 0 = the prompt's prefix arrived via the
            # fleet store (handoff or tier hit); 0 with prefix_hit_pages
            # 0 = the self-prefill path
            summary["prefix_hit_pages"] = \
                state.prefill_stats.get("prefix_hit_pages", 0)
            imported = state.prefill_stats.get("imported_pages", 0)
            if imported:
                summary["imported_pages"] = imported
        return summary

    def _account_done(self, state, reason, error=None):
        """Outcome counter (+ trace exemplar), the request span and
        ``pending.summary`` for the HTTP layer."""
        pending = state.pending
        outcome = "error" if error is not None else reason
        summary = self._slo_summary(state, outcome)
        if error is not None:
            summary["error"] = "%s: %s" % (type(error).__name__, error)
        pending.summary = summary
        catalog.REQUESTS_FINISHED.inc(path="generate", outcome=outcome)
        tracing.note_outcome("generate", outcome, pending.trace)
        if pending.trace is not None:
            tracing.span_from(pending.t_enqueue, "gen.request",
                              ctx=pending.trace, **summary)
        return summary

    def _release(self, slot):
        """Free ``slot`` in the engine and in the draft."""
        self.engine.release(slot)
        if self._draft is not None:
            self._draft.release(slot)

    def _finish(self, slot, state, reason, slots):
        self._release(slot)
        del slots[slot]
        self.drain_rate.note_finish()
        summary = self._account_done(state, reason)
        state.pending._resolve({
            "tokens": [int(t) for t in state.generated],
            "finish_reason": reason, "n_prompt": state.prompt_len,
            "slo": summary})

    def _doa_admission(self, req):
        """504 a request whose deadline (minus the admit margin) passed
        while it queued — BEFORE any prefill is spent on it."""
        pending, prompt, budget, temperature = req
        catalog.DEADLINE_EXCEEDED.inc(stage="admission")
        over_ms = (time.perf_counter() - pending.deadline) * 1e3
        self._account_done(_SlotState(pending, prompt, budget, temperature),
                           "deadline")
        # over_ms < 0: not yet expired, but with less budget left than
        # the admit margin
        detail = "%.0f ms past it" % over_ms if over_ms >= 0 else \
            "%.0f ms of budget left" % -over_ms
        pending._fail(DeadlineExceededError(
            "deadline exceeded before admission (%s, admit margin %.0f ms) "
            "— rejected without a prefill"
            % (detail, self._admit_min_s * 1e3)))

    def _sweep_held_deadlines(self):
        """504 every parked request whose deadline passed (stage
        ``held``) before a prefill is spent on it; a preempted one fails
        with its partial accounting."""
        if not self._held_q:
            return
        now = time.perf_counter()
        for e in list(self._held_q):
            pending, prompt, budget, temperature = e["req"]
            dl = pending.deadline
            if dl is None or now + self._admit_min_s <= dl:
                continue
            self._held_q.remove(e)
            catalog.DEADLINE_EXCEEDED.inc(stage="held")
            st = e["resume"] or _SlotState(pending, prompt, budget,
                                           temperature)
            st.hold_ms += (now - e["since"]) * 1e3
            self._account_done(st, "deadline")
            pending._fail(DeadlineExceededError(
                "deadline exceeded while parked in the held lane (reason "
                "%s) — evicted before a prefill" % e["reason"]))

    # -- tenant budgets and the held lane ---------------------------------
    def _tenant_budget_for(self, pending):
        """This request's tenant token budget (0 = unlimited); anonymous
        requests pool under the "" tenant."""
        b = self._tenant["token_budget_map"].get(pending.tenant or "")
        return self._tenant["token_budget"] if b is None else b

    def _tenant_over(self, pending):
        b = self._tenant_budget_for(pending)
        return b > 0 and self._tenant_used.get(pending.tenant or "", 0) >= b

    def _tenant_note(self, st, m):
        """Charge ``m`` freshly emitted tokens to the request's tenant
        window and to its class counter (tenant ids are never labels)."""
        if m <= 0:
            return
        key = st.pending.tenant or ""
        self._tenant_used[key] = self._tenant_used.get(key, 0) + m
        catalog.TENANT_TOKENS.inc(float(m), **{"class": st.pending.priority})

    def _park(self, entry, reason):
        """Park an admission on the held lane: a preempted request at the
        FRONT (it was admitted before anything parked fresh), a fresh one
        at the back. Callers guarantee room."""
        entry["since"] = time.perf_counter()
        entry["reason"] = reason
        if entry["resume"] is not None:
            self._held_q.insert(0, entry)
        else:
            self._held_q.append(entry)

    def _held_pick(self, snap, slots, state):
        """The next admissible held entry, or None: high class before
        low, FIFO within a class — except that a tenant-budget block is
        bypassable (budgets are per tenant) while a page block holds the
        class (the pool is shared; admitting around it would starve the
        head)."""
        for cls in PRIORITY_CLASSES:
            for e in self._held_q:
                if e["req"][0].priority != cls:
                    continue
                if not state["saw_stop"] and self._tenant_over(e["req"][0]):
                    continue  # budget-blocked: later tenants may pass
                if self._held_admissible(e, snap, slots):
                    self._held_q.remove(e)
                    return e
                break  # page-blocked head: the class waits (FIFO)
        return None

    def _held_admissible(self, e, snap, slots):
        if not self._paged or not slots:
            # an empty engine admits unconditionally (the prefill evicts
            # prefix-cache pages as it must)
            return True
        if e["resume"] is not None:
            st = e["resume"]
            return self.engine.can_admit(
                e["resume_prompt"], max(1, st.budget - len(st.generated)),
                snapshot=snap)
        req = e["req"]
        return self.engine.can_admit(req[1], req[2], snapshot=snap)

    def _admit_held_behind(self, entry, req):
        """FIFO per class for a fresh pull that would otherwise admit: if
        the lane holds work of its class, park behind it (another
        tenant's budget block excepted). The caller checks
        ``entry["since"]``."""
        for e in self._held_q:
            if e["req"][0].priority != req[0].priority:
                continue
            if e["reason"] == "budget" and \
                    (e["req"][0].tenant or "") != (req[0].tenant or ""):
                continue
            self._park(entry, e["reason"])
            return

    # -- preemption to the held lane ----------------------------------------
    def _preemptible(self, st):
        """Only greedy requests on a paged engine without a draft resume
        token-identically (a sampled stream's draws are positional), the
        resume prompt must fit the prefill buckets, and the lane must
        have room."""
        return (self._paged and self._draft is None and
                st.temperature <= 0 and
                len(st.generated) < st.budget and
                st.prompt_len + len(st.generated)
                <= self.engine.max_prompt_len and
                len(self._held_q) < self._tenant["held_depth"])

    def _preempt_to_held(self, slot, st, slots, reason):
        """Preempt an in-flight request between (mega)steps, with no
        megastep in flight (callers :meth:`_ms_settle` first): its full KV
        pages park in the prefix cache, the slot frees, and the request
        waits on the held lane. Its
        re-admission prefills prompt + generated — the cache match
        recomputes only the suffix — so the greedy continuation is
        token-identical to an uninterrupted run."""
        resume_prompt = np.concatenate(
            [st.prompt, np.asarray(st.generated, np.int32)])
        n_cached = self.engine.preempt_release(slot, resume_prompt[:-1])
        del slots[slot]
        catalog.PREEMPTIONS_TO_HELD.inc(reason=reason)
        if st.pending.trace is not None:
            tracing.record("gen.preempt", ctx=st.pending.trace, slot=slot,
                           reason=reason, n_generated=len(st.generated),
                           pages_cached=n_cached)
        entry = {"req": (st.pending, st.prompt, st.budget, st.temperature),
                 "resume": st, "resume_prompt": resume_prompt,
                 "since": None, "reason": None}
        self._park(entry, reason)
        self._n_active = len(slots)

    def _preempt_victim(self, slots, cls="low"):
        """The YOUNGEST preemptible slot of ``cls`` (latest first token):
        the most recently admitted request goes back behind the lane."""
        best = None
        for s, st in slots.items():
            if st.pending.priority != cls or not self._preemptible(st):
                continue
            if best is None or st.t_first > slots[best].t_first:
                best = s
        return best

    def _preempt_for_pages(self, slots, snap):
        """Page pressure blocked a HIGH-class admission: preempt one
        low-class victim; returns a fresh admission snapshot."""
        if self._preempt_victim(slots) is None:
            return snap
        self._ms_settle(slots)
        s = self._preempt_victim(slots)   # the megastep may finish it
        if s is not None:
            self._preempt_to_held(s, slots[s], slots, "pages")
        return self.engine.admission_state()

    # -- the SLO control loop -----------------------------------------------
    def _slo_update(self, slots, now):
        """Compare live TTFT/TPOT with the per-class targets. A violating
        class accrues ``slo_violation_seconds_total``; a HIGH-class
        violation sustained past ``slo_sustain_s`` sets ``_slo_pressed``,
        which pins brownout pressure to 1, clamps the megastep K to 1 and
        drives low-class preemption in :meth:`_iterate`."""
        if not self._slo_ttft and not self._slo_tpot:
            return
        dt = min(max(now - self._slo_last_check, 0.0), 1.0)
        self._slo_last_check = now
        bad = {}
        for cls, target in self._slo_tpot.items():
            t_s = target / 1e3
            for st in slots.values():
                n = len(st.generated)
                # (now - t_first) / (n - 1) >= the realized TPOT and
                # keeps growing while the slot starves: the live signal
                if st.pending.priority == cls and n >= 2 and \
                        st.t_first is not None and \
                        (now - st.t_first) / (n - 1) > t_s:
                    bad[cls] = True
                    break
        if self._slo_ttft:
            waiting = [e["req"][0] for e in self._held_q]
            with self._q.mutex:
                waiting += [it[0] for it in self._q.queue
                            if isinstance(it, tuple)]
            for cls, target in self._slo_ttft.items():
                if bad.get(cls):
                    continue
                t_s = target / 1e3
                for p in waiting:
                    if p.priority == cls and now - p.t_enqueue > t_s:
                        bad[cls] = True
                        break
        for cls in set(self._slo_ttft) | set(self._slo_tpot):
            if bad.get(cls):
                if self._slo_bad_since.get(cls) is None:
                    self._slo_bad_since[cls] = now
                catalog.SLO_VIOLATION_SECONDS.inc(dt, **{"class": cls})
            else:
                self._slo_bad_since[cls] = None
        hs = self._slo_bad_since.get("high")
        pressed = hs is not None and \
            now - hs >= self._tenant["slo_sustain_s"]
        if pressed and not self._slo_pressed:
            tracing.record("slo.pressure", sustained_s=round(now - hs, 3))
        self._slo_pressed = pressed

    def _evict_expired(self, slots):
        """Evict in-flight slots whose deadline passed (504 with partial
        accounting) so the slot goes to a request that can still meet
        its deadline."""
        now = time.perf_counter()
        for s, st in list(slots.items()):
            dl = st.pending.deadline
            if dl is None or now <= dl:
                continue
            catalog.DEADLINE_EXCEEDED.inc(stage="decode")
            self._release(s)
            del slots[s]
            self.drain_rate.note_finish()
            self._account_done(st, "deadline")
            st.pending._fail(DeadlineExceededError(
                "deadline exceeded after %d generated tokens — slot "
                "evicted between decode steps" % len(st.generated)))
        self._n_active = len(slots)

    def _admit(self, slot, req, slots, hold_ms=0.0, resume=None,
               resume_prompt=None):
        """Prefill ``req`` into ``slot`` and take its first token. A
        ``resume`` (a preempted request's state) prefills
        ``resume_prompt`` (prompt + generated) instead and keeps its
        tokens, TTFT stamp and accounting."""
        pending, prompt, budget, temperature = req
        if resume is not None:
            state = resume
            state.hold_ms += hold_ms
            prefill_prompt = resume_prompt
            prefill_budget = max(1, state.budget - len(state.generated))
        else:
            state = _SlotState(pending, prompt, budget, temperature)
            state.hold_ms = hold_ms
            prefill_prompt, prefill_budget = prompt, budget
            if pending.trace is not None:
                tracing.span_from(pending.t_enqueue, "gen.queue_wait",
                                  ctx=pending.trace, slot=slot)
        t0 = time.perf_counter()
        try:
            with tracing.use(pending.trace):
                if self._paged:
                    # reserve exactly this request's worst case
                    logits = self.engine.prefill(
                        slot, prefill_prompt, max_new_tokens=prefill_budget)
                else:
                    logits = self.engine.prefill(slot, prefill_prompt)
                if self._draft is not None:
                    try:
                        self._draft.prefill(slot, prompt)
                    except DeviceStateError:
                        raise
                    except Exception:
                        # a draft-only failure (its bucket grid): free
                        # the target slot and fail just this request
                        self.engine.release(slot)
                        raise
        except DeviceStateError as e:
            # the pools may be half written: every co-resident sequence
            # is lost too — fail the cohort and reset
            self._account_done(state, "error", error=e)
            pending._fail(e)
            self._fail_cohort(slots, e)
            return
        except Exception as e:  # a bad prompt fails only its request
            self._account_done(state, "error", error=e)
            pending._fail(e)
            return
        if self._paged:
            state.prefill_stats = dict(self.engine.last_prefill_stats)
        try:
            catalog.GENERATION_PREFILLS.inc()
            catalog.GENERATION_PREFILL_MS.observe(
                (time.perf_counter() - t0) * 1e3)
            # token k occupies cache position prompt_len + k - 1; on
            # resume the budget counts every generated token
            cap = self.engine.max_len - int(self.engine.lengths[slot])
            if resume is None:
                state.budget = min(budget, cap)
            else:
                state.budget = min(state.budget,
                                   len(state.generated) + cap)
            slots[slot] = state
            tok = self._sample_first(logits, temperature)
            catalog.GENERATION_TOKENS.inc()
            self._tenant_note(state, 1)
            state.generated.append(tok)
            now = time.perf_counter()
            if resume is None:
                state.t_first = now
            state.t_last = now
            if self.eos_id is not None and tok == self.eos_id:
                self._finish(slot, state, "eos", slots)
            elif len(state.generated) >= state.budget:
                self._finish(slot, state, "length", slots)
            else:
                self.engine.set_input_token(slot, tok)
                if self._draft is not None:
                    self._draft.set_input_token(slot, tok)
        except Exception as e:  # host-side bookkeeping: fail this request
            slots.pop(slot, None)
            self._release(slot)
            self._account_done(state, "error", error=e)
            pending._fail(e)

    def _fail_cohort(self, slots, error):
        """Fail every in-flight sequence and free the slots; a lost pool
        state also resets the engine and the draft."""
        if slots:
            catalog.GENERATION_FAILED.inc(float(len(slots)))
        # a chained megastep rode the state that just failed: drop its
        # handle unsynced
        self._ms_inflight = None
        self._last_result_t = None
        for s, st in list(slots.items()):
            try:
                self._account_done(st, "error", error=error)
            except Exception:
                pass  # accounting must never mask the cohort failure
            st.pending._fail(error)
            for eng in (self.engine, self._draft):
                if eng is not None:
                    with contextlib.suppress(Exception):
                        eng.release(s)
            del slots[s]
        if isinstance(error, DeviceStateError):
            self.engine.reset()
            if self._draft is not None:
                self._draft.reset()  # its context is orphaned too
        self._n_active = 0

    def _can_spec(self, slots):
        """Whether a speculative round fits every in-flight slot
        (``paged_kv.can_speculate``)."""
        from .paged_kv import can_speculate
        return can_speculate(self.engine, self._draft, slots)

    def _pull(self, slots, state):
        """The next admission entry from the held lane or the queue, or
        None to stop admitting this iteration."""
        entry = self._held_pick(self._snap, slots, state)
        if entry is not None:
            return entry
        if state["saw_stop"] or \
                len(self._held_q) >= self._tenant["held_depth"]:
            # a full lane stops pulling: backpressure stays in the
            # bounded queue
            return None
        try:
            # block only when fully idle: active slots or parked work
            # mean the loop must keep cycling
            item = self._q.get_nowait() if (slots or self._held_q) \
                else self._q.get()
        except queue.Empty:
            return None
        if item is _STOP:
            state["saw_stop"] = True
            return None
        return {"req": item, "resume": None, "resume_prompt": None,
                "since": None, "reason": None}

    def _gate_fresh(self, entry, slots, state):
        """Apply the admission gates to a freshly pulled entry: the
        level-2 budget clamp, the dead-on-arrival check, the tenant
        budget, page pressure (which may preempt low-class work for a
        high-class request) and FIFO behind parked work of its class.
        Returns "admit", "next" (handled: pull again) or "stop"."""
        req = entry["req"]
        if self.brownout.level() >= 2 and req[2] > self._shed_token_cap:
            # clamp BEFORE the page gate: held-vs-admit is decided on the
            # budget the request will actually get
            req = (req[0], req[1], self._shed_token_cap, req[3])
            entry["req"] = req
        dl = req[0].deadline
        if dl is not None and time.perf_counter() + self._admit_min_s > dl:
            self._doa_admission(req)
            return "next"
        if not state["saw_stop"] and self._tenant_over(req[0]):
            # over-budget tenant: throttle to the lane and keep pulling —
            # one tenant's burn must not block the others
            self._park(entry, "budget")
            return "next"
        if self._paged and slots and not self.engine.can_admit(
                req[1], req[2], snapshot=self._snap):
            if req[0].priority == "high":
                self._snap = self._preempt_for_pages(slots, self._snap)
            if slots and not self.engine.can_admit(req[1], req[2],
                                                   snapshot=self._snap):
                self._park(entry, "pages")
                return "stop"
        self._admit_held_behind(entry, req)
        return "next" if entry["since"] is not None else "admit"

    def _iterate(self, slots, state):
        """One scheduler iteration (enforcement, admission, one decode
        step, speculative round or megastep); returns True when the loop
        should exit."""
        now = time.perf_counter()
        # tenant budgets are per fixed window: rolling it re-admits every
        # throttled tenant
        if now - self._tenant_window_t0 >= self._tenant["budget_window_s"]:
            self._tenant_window_t0 = now
            self._tenant_used.clear()
        self._evict_expired(slots)
        self._sweep_held_deadlines()
        self._slo_update(slots, time.perf_counter())
        self.brownout.update(self._pressure())
        if not state["saw_stop"]:
            # enforcement between (mega)steps, never mid-step: an
            # over-budget tenant's slots park until its window rolls, and
            # a sustained high-class SLO violation preempts one low-class
            # victim an iteration
            if any(self._tenant_over(st.pending) and self._preemptible(st)
                   for st in slots.values()) or (
                       self._slo_pressed and
                       self._preempt_victim(slots) is not None):
                self._ms_settle(slots)
            for s, st in list(slots.items()):
                if self._tenant_over(st.pending) and self._preemptible(st):
                    self._preempt_to_held(s, st, slots, "budget")
            if self._slo_pressed:
                s = self._preempt_victim(slots)
                if s is not None:
                    self._preempt_to_held(s, slots[s], slots, "slo")
        self._snap = self.engine.admission_state() if self._paged else None
        while len(slots) < self.engine.max_slots:
            entry = self._pull(slots, state)
            if entry is None:
                break
            fresh = entry["since"] is None
            if fresh:
                verdict = self._gate_fresh(entry, slots, state)
                if verdict == "stop":
                    break
                if verdict == "next":
                    continue
            hold_ms = 0.0
            req = entry["req"]
            if not fresh:
                hold_ms = (time.perf_counter() - entry["since"]) * 1e3
                if req[0].trace is not None:
                    tracing.span_from(entry["since"], "gen.hold",
                                      ctx=req[0].trace,
                                      reason=entry["reason"])
            self._admit(self.engine.free_slots()[0], req, slots,
                        hold_ms=hold_ms, resume=entry["resume"],
                        resume_prompt=entry["resume_prompt"])
            if self._paged:
                self._snap = self.engine.admission_state()
        self._n_active = len(slots)
        if not slots:
            if self._ms_inflight is not None:
                # every rider of the chained megastep left: sync it and
                # apply nothing (only=())
                self.engine.megastep_sync(self._ms_inflight["handle"],
                                          only=())
                self._ms_inflight = None
            # idle: the next decode's lead-in is queue wait, not host gap
            self._last_result_t = None
            if self._held_q and not state["saw_stop"]:
                # parked work with nothing decoding (a budget throttle
                # waiting for its window): nap a tick instead of spinning
                time.sleep(0.002)
            return state["saw_stop"] and not self._held_q
        riders = [st.pending.trace.request_id for st in slots.values()
                  if st.pending.trace is not None]
        t0 = time.perf_counter()
        # the decode host gap: from the last decode result landing to
        # this dispatch (a chained megastep counted its zero gap when it
        # was dispatched)
        if self._ms_inflight is None and self._last_result_t is not None:
            gap = max(0.0, t0 - self._last_result_t)
            catalog.DECODE_HOST_GAP_SECONDS.inc(gap)
            catalog.DECODE_HOST_GAP.observe(gap)
        if self._draft is not None:
            # brownout level 1+ turns speculation off: the draft's steps
            # are overhead when every cycle belongs to committed work
            if self.brownout.level() >= 1:
                reason = "brownout"
            elif not self._can_spec(slots):
                reason = "capacity"
            elif any(st.temperature > 0 for st in slots.values()):
                reason = "sampled"
            else:
                return self._spec_iterate(slots, t0, riders)
            catalog.SPECULATIVE_FALLBACK.inc(reason=reason)
        if self._megastep_k > 1 or self._ms_inflight is not None:
            k = self._clamp_k(slots)
            if k > 1 or self._ms_inflight is not None:
                return self._megastep_iterate(slots, state, k, t0)
        # K = 1: one decode step across every active slot
        step_idx = self._step_idx
        self._step_idx += 1
        toks = self.engine.decode_step(temperatures=self._ms_temps(slots),
                                       seed=self._seed, step=step_idx)
        if self._draft is not None:
            # keep the draft's cache aligned: it ingests the input token
            # this step wrote; its own emission is discarded
            self._draft.decode_step()
        now = time.perf_counter()
        self._last_result_t = now
        self._update_step_ewma(now - t0)
        catalog.GENERATION_DECODE_STEP_MS.observe((now - t0) * 1e3)
        catalog.GENERATION_DECODE_STEPS.inc()
        catalog.GENERATION_SLOT_OCCUPANCY.observe(len(slots))
        catalog.GENERATION_TOKENS.inc(float(len(slots)))
        tracing.span_from(t0, "gen.decode_step", ctx=None, step=step_idx,
                          n_slots=len(slots), request_ids=riders)
        for s, st in list(slots.items()):
            tok = int(toks[s])
            st.generated.append(tok)
            self._tenant_note(st, 1)
            st.t_last = now
            st.decode_steps += 1
            if self.eos_id is not None and tok == self.eos_id:
                self._finish(s, st, "eos", slots)
            elif len(st.generated) >= st.budget or \
                    self.engine.lengths[s] >= self.engine.max_len:
                self._finish(s, st, "length", slots)
            elif self._draft is not None:
                self._draft.set_input_token(s, tok)
        self._n_active = len(slots)
        return False

    def _spec_iterate(self, slots, t0, riders):
        """One speculative round over every (greedy) slot."""
        from .paged_kv import speculative_round
        left = {s: st.budget - len(st.generated) for s, st in slots.items()}
        emitted, accepted = speculative_round(
            self.engine, self._draft, set(slots), left, eos_id=self.eos_id)
        step_idx = self._step_idx
        self._step_idx += 1
        now = time.perf_counter()
        self._last_result_t = now
        catalog.GENERATION_DECODE_STEP_MS.observe((now - t0) * 1e3)
        catalog.GENERATION_DECODE_STEPS.inc()
        catalog.GENERATION_SLOT_OCCUPANCY.observe(len(slots))
        catalog.GENERATION_TOKENS.inc(
            float(sum(len(v) for v in emitted.values())))
        # 'accepted' is exactly what speculative_accepted_tokens_total
        # counted for this round
        tracing.span_from(t0, "gen.spec_round", ctx=None, step=step_idx,
                          n_slots=len(slots),
                          drafted=self._spec_k * len(slots),
                          accepted=sum(accepted.values()),
                          request_ids=riders)
        for s, st in list(slots.items()):
            toks = emitted[s]
            st.generated.extend(toks)
            self._tenant_note(st, len(toks))
            st.t_last = now
            st.decode_steps += 1
            st.spec_rounds += 1
            st.spec_accepted += accepted[s]
            if self.eos_id is not None and toks and \
                    toks[-1] == self.eos_id:
                self._finish(s, st, "eos", slots)
            elif len(st.generated) >= st.budget or \
                    self.engine.lengths[s] >= self.engine.max_len:
                self._finish(s, st, "length", slots)
        self._n_active = len(slots)
        return False

    # -- megastep decoding ------------------------------------------------
    def _update_step_ewma(self, dt):
        """Observed wall seconds per decode trip (EWMA): what
        :meth:`_clamp_k` turns deadline slack into trips with."""
        if self._step_ewma_s is None:
            self._step_ewma_s = dt
        else:
            self._step_ewma_s = 0.8 * self._step_ewma_s + 0.2 * dt

    def _clamp_k(self, slots):
        """This cohort's megastep depth: ``megastep_k`` clamped by the
        WIDEST remaining budget (frozen slots cost nothing, so the widest
        rider sets the useful depth) and by each in-flight deadline's
        slack in observed trip times, so eviction and admission run
        before the tightest deadline can pass. Under sustained SLO
        pressure K is 1: admission and preemption must never sit K trips
        behind the device while the high class violates its target."""
        if self._slo_pressed:
            return 1
        k = min(self._megastep_k,
                max(1, max((st.budget - len(st.generated)
                            for st in slots.values()), default=1)))
        ewma = self._step_ewma_s
        if ewma and ewma > 0:
            now = time.perf_counter()
            for st in slots.values():
                dl = st.pending.deadline
                if dl is not None:
                    k = min(k, max(1, int((dl - now) / ewma)))
        return max(1, k)

    def _ms_caps(self, slots):
        """Per-slot emission caps for the device: min(remaining budget,
        remaining page reservation)."""
        caps = np.zeros(self.engine.max_slots, np.int64)
        for s, st in slots.items():
            caps[s] = max(1, min(
                st.budget - len(st.generated),
                int(self.engine._reserved[s]) -
                int(self.engine.lengths[s])))
        return caps

    def _ms_temps(self, slots):
        temps = np.zeros(self.engine.max_slots, np.float32)
        for s, st in slots.items():
            temps[s] = st.temperature
        return temps

    def _ms_can_chain(self, slots, state, riders):
        """Whether megastep N+1 may be dispatched before N is synced: only
        with no admission work pending (empty queue, empty held lane, not
        stopping), so a prefill never waits behind K more trips, and only
        when every tracked slot rode N (``riders``, checked by identity):
        a chained megastep inherits N's device live mask, so a slot
        admitted after N would never decode in it."""
        return (self._megastep_k > 1 and bool(slots) and
                not state["saw_stop"] and not self._held_q and
                self._q.qsize() == 0 and
                all(riders.get(s) is st for s, st in slots.items()))

    def _megastep_iterate(self, slots, state, k, t0):
        """One iteration at megastep granularity: take the in-flight
        (chained) megastep or dispatch a fresh one; chain megastep N+1
        from N's device outputs before syncing N when the gate allows;
        then hand N's tokens to its riders, each token's time spread over
        the megastep's wall time (TPOT)."""
        eng = self.engine
        eos = -1 if self.eos_id is None else int(self.eos_id)
        info = self._ms_inflight
        self._ms_inflight = None
        if info is None:
            handle = eng.megastep_dispatch(
                self._seed, self._step_idx, k,
                temperatures=self._ms_temps(slots),
                caps=self._ms_caps(slots), eos_id=eos)
            info = {"handle": handle, "t0": t0, "riders": dict(slots)}
        handle = info["handle"]
        k2 = self._clamp_k(slots)
        if k2 > 1 and self._ms_can_chain(slots, state, info["riders"]):
            # N+1 rides N's device tokens, lengths and live mask, and
            # device arithmetic for its caps and step0: no host read
            t_chain = time.perf_counter()
            h2 = eng.megastep_dispatch(
                self._seed, handle["step0"] + handle["trips"], k2,
                temperatures=self._ms_temps(slots),
                caps=handle["caps"] - handle["n_emitted"], eos_id=eos,
                live=handle["live"], tokens=handle["tokens"],
                lengths=handle["lengths"])
            catalog.DECODE_HOST_GAP_SECONDS.inc(0.0)
            catalog.DECODE_HOST_GAP.observe(0.0)
            self._ms_inflight = {"handle": h2, "t0": t_chain,
                                 "riders": dict(slots)}
        self._ms_apply(info, slots)
        return False

    def _ms_settle(self, slots):
        """Sync and apply a chained megastep still in flight. Preemption
        calls this first: a preempted request resumes in the same
        ``_SlotState``, perhaps in the slot it left within the same
        iteration, so the identity check of :meth:`_ms_apply` would take
        it for a rider and write the megastep's lengths, pending token and
        tokens over its fresh prefill."""
        info = self._ms_inflight
        if info is not None:
            self._ms_inflight = None
            self._ms_apply(info, slots)

    def _ms_apply(self, info, slots):
        """Sync the megastep of ``info`` and hand its tokens to the riders
        still tracked, each token's time spread over the megastep's wall
        time (TPOT)."""
        eng = self.engine
        handle = info["handle"]
        # identity, not membership: a slot evicted and re-admitted while
        # the megastep flew holds another request now
        only = [s for s, st in info["riders"].items()
                if slots.get(s) is st]
        res = eng.megastep_sync(handle, only=only)
        trips = int(res["trips"])
        now = time.perf_counter()
        self._last_result_t = now
        dt = max(now - info["t0"], 0.0)
        per_trip = dt / max(trips, 1)
        self._update_step_ewma(per_trip)
        step_idx = self._step_idx
        self._step_idx += trips
        catalog.GENERATION_MEGASTEPS.inc()
        catalog.GENERATION_MEGASTEP_TRIPS.observe(float(trips))
        catalog.GENERATION_DECODE_STEPS.inc(float(trips))
        catalog.GENERATION_DECODE_STEP_MS.observe(per_trip * 1e3)
        catalog.GENERATION_SLOT_OCCUPANCY.observe(len(slots))
        tracing.span_from(info["t0"], "gen.megastep", ctx=None,
                          step=step_idx, trips=trips,
                          k=int(handle["k_eff"]), n_slots=len(slots),
                          request_ids=[st.pending.trace.request_id
                                       for st in info["riders"].values()
                                       if st.pending.trace is not None])
        out = res["out"]  # [trips, max_slots]; -1 = frozen that trip
        total = 0
        for s in only:
            st = slots.get(s)
            if st is None:
                continue
            toks = [int(t) for t in out[:, s] if t >= 0]
            if not toks:
                continue
            m = len(toks)
            total += m
            self._tenant_note(st, m)
            st.generated.extend(toks)
            # a slot emits in trips 0 .. m-1, so its last token landed
            # m/trips of the way through the megastep
            st.t_last = info["t0"] + dt * m / max(trips, 1)
            st.decode_steps += m
            if self.eos_id is not None and toks[-1] == self.eos_id:
                self._finish(s, st, "eos", slots)
            elif len(st.generated) >= st.budget or \
                    eng.lengths[s] >= eng.max_len:
                self._finish(s, st, "length", slots)
        catalog.GENERATION_TOKENS.inc(float(total))
        self._n_active = len(slots)

    def _loop(self):
        if self.device.type == "cuda":
            # this thread owns the engine: launch on its current stream
            torch.cuda.set_device(self.device)
        slots = {}
        state = {"saw_stop": False}
        while True:
            try:
                if self._iterate(slots, state):
                    break
            except Exception as e:
                # NOTHING may kill this thread short of close(): a failed
                # decode step fails the in-flight cohort and the loop
                # keeps serving
                self._fail_cohort(slots, e)
        self._n_active = 0
