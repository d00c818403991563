"""Autoregressive generation on the port: the decoder model, its on-disk
form, the reference decode loops and the continuous-batching scheduler —
the PyTorch port of ``paddle_tpu/serving/generation.py``.

  model     — :class:`TransformerDecoderModel`, a pre-LN decoder LM as
              plain functions over a parameter dict of tensors (the same
              tree as the reference's params pytree: ``embed``,
              ``blocks[i].{ln1_s, ln1_b, wq, wk, wv, wo, ln2_s, ln2_b, w1,
              b1, w2, b2}``, ``lnf_s``, ``lnf_b``, ``head``).
  schedule  — :class:`GenerationScheduler` runs the paged engine
              (``serving/paged_kv.py``) on a loop thread with CONTINUOUS
              batching: between decode steps queued requests are admitted
              into free slots and finished sequences are evicted, so the
              device batch stays full under load.

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

Not ported yet: the dense ``DecodeEngine``, speculative decoding,
tenancy / SLO control / brownout / preemption.
"""

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
from ..ops.attention import dot_product_attention, paged_chunk_attention
from .batcher import (DeadlineExceededError, DrainRateEstimator,
                      OverloadedError, PendingResult, ServingClosedError,
                      resolve_serving_knobs)

__all__ = [
    "TransformerDecoderModel", "DeviceStateError", "GenerationScheduler",
    "full_recompute_generate", "greedy_generate", "resolve_generation_knobs",
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
                             num_pages=None, kv_quant_dtype=None,
                             kv_quant_group=None, megastep_k=None,
                             paged=False):
    """Resolve ``(max_slots, max_len, buckets)`` from explicit values or
    the ``FLAGS_generation_*`` defaults, validating each (errors name the
    flag). Buckets come back as a sorted tuple clipped to lengths that
    leave room for one generated token. With ``paged=True`` the return
    extends to ``(..., page_size, num_pages, kv_quant_dtype,
    kv_quant_group, megastep_k)``; ``num_pages=0`` sizes the pool to the
    dense-equivalent budget ``ceil(max_slots × max_len / page_size)``,
    DOUBLED when the pages are quantized (int8/fp8 pages cost half the
    bf16 bytes); ``kv_quant_group=0`` resolves to one group per page;
    ``megastep_k=0`` resolves to ``min(8, max_len - 1)``."""
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
            kv_quant_dtype, kv_quant_group, megastep_k)


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
        table = page_table_row[None]
        for i, (blk, kp, vp) in enumerate(zip(params["blocks"], k_pools,
                                              v_pools)):
            h = _layer_norm(x, blk["ln1_s"], blk["ln1_b"])
            q, k, v = self._qkv(blk, h)
            ks = vs = None
            if kv_quant is None:
                kp.index_put_((write_pids, write_offs), k[0])
                vp.index_put_((write_pids, write_offs), v[0])
            else:
                ks, vs = k_scales[i], v_scales[i]
                for pool, sc, val in ((kp, ks, k), (vp, vs, v)):
                    self._quant_append(pool, sc, win_pids[None],
                                       w_idx[None], write_offs[None], val,
                                       kv_quant)
            a = paged_chunk_attention(q, kp, vp, table, base, k_scale=ks,
                                      v_scale=vs, quant=kv_quant)
            x = x + a.reshape(x.shape) @ _wmat(blk["wo"], self.dtype)
            x = self._ffn(blk, x)
        x = _layer_norm(x, params["lnf_s"], params["lnf_b"])
        return x[0, n - 1] @ _wmat(params["head"], self.dtype)

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


_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """``x * c mod 2**32`` for ``x`` in [0, 2**32) (a Python int or an
    int64 tensor) and a 32-bit constant ``c``, split at 16 bits so no
    product leaves int64."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(h):
    """MurmurHash3's 32-bit finalizer: a bijection of [0, 2**32) whose
    output bits each depend on every input bit."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


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


def greedy_generate(engine, prompts, max_new_tokens, *, eos_id=None):
    """Synchronous greedy decode of up to ``engine.max_slots`` prompts on
    the calling thread — the no-scheduler reference path.
    ``max_new_tokens``: int or per-prompt list. Returns a list of
    generated-token lists (capped by cache capacity)."""
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
    for i, prompt in enumerate(prompts):
        logits = engine.prefill(i, prompt, max_new_tokens=budgets[i])
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
# Continuous-batching scheduler
# ---------------------------------------------------------------------------


def _resolve_deadline_knobs():
    """The scheduler's deadline and Retry-After knobs from the flags,
    validated (errors name the flag)."""
    from .. import flags
    out = {}
    for name in ("deadline_default_ms", "deadline_admit_min_ms",
                 "shed_retry_floor_s", "shed_retry_cap_s"):
        raw = getattr(flags, name)
        try:
            v = float(raw)
        except (TypeError, ValueError):
            raise ValueError("FLAGS_%s must be a number (got %r)"
                             % (name, raw)) from None
        if not math.isfinite(v) or v < 0:
            raise ValueError("FLAGS_%s must be a finite number >= 0 "
                             "(got %r)" % (name, raw))
        out[name] = v
    if out["shed_retry_cap_s"] < out["shed_retry_floor_s"]:
        raise ValueError("FLAGS_shed_retry_cap_s must be >= "
                         "FLAGS_shed_retry_floor_s")
    return out


class _STOP:
    pass


class _SlotState:
    __slots__ = ("pending", "prompt_len", "budget", "temperature",
                 "generated", "t_first", "t_last", "decode_steps",
                 "hold_ms", "prefill_stats")

    def __init__(self, pending, prompt, budget, temperature):
        self.pending = pending
        self.prompt_len = int(prompt.size)
        self.budget = budget
        self.temperature = temperature
        self.generated = []
        self.t_first = None       # perf stamp of the first token (TTFT)
        self.t_last = None        # perf stamp of the newest token (TPOT)
        self.decode_steps = 0
        self.hold_ms = 0.0        # admission hold at the queue head
        self.prefill_stats = None


class GenerationScheduler:
    """Iteration-level (continuous) batching over a
    :class:`~.paged_kv.PagedDecodeEngine`.

    ``submit(prompt, ...)`` → :class:`PendingResult` resolving to
    ``{"tokens": [...], "finish_reason": "eos"|"length", "n_prompt": n,
    "slo": {...}}``. A loop thread owns the engine: between decode steps
    it admits queued requests into free slots (prefill) and evicts
    finished sequences. Admission is bounded (``queue_depth``, default
    ``FLAGS_serving_queue_depth``): a full queue raises
    :class:`OverloadedError` (HTTP 503). Admission also counts free
    pages: a request leaves the queue only when the pool (plus evictable
    prefix-cache pages) covers its worst case; until then it is HELD at
    the queue head while decoding continues. A request that could never
    fit the pool is rejected at ``submit`` (ValueError → HTTP 400).

    Deadlines (``deadline_ms``, from ``X-Deadline-Ms``, defaulting to
    ``FLAGS_deadline_default_ms``): a request dead on arrival is 504'd
    before any prefill; an in-flight slot past its deadline is evicted
    between decode steps.

    Greedy requests (temperature 0) are deterministic and independent of
    co-scheduling; sampled ones draw under ``(seed, decode step, slot)``
    (:func:`draw_tokens`), first tokens under steps -1, -2, ... in
    admission order.

    Megastep decoding (``engine.megastep_k`` > 1): each iteration
    dispatches up to K decode trips at once
    (:meth:`~.paged_kv.PagedDecodeEngine.megastep_dispatch`), K clamped
    by the widest remaining budget and the tightest deadline's slack
    (:meth:`_clamp_k`); when no admission work waits, megastep N+1 is
    dispatched from N's device outputs before N is synced
    (:meth:`_ms_can_chain`). Trip t draws as step ``step0 + t`` would,
    so the streams are those of the step-at-a-time loop (K = 1).
    ``close()`` drains: no new admissions, every queued and in-flight
    sequence decodes to its natural finish, then the loop exits.
    """

    def __init__(self, engine, *, eos_id=None, queue_depth=None,
                 default_max_new_tokens=64, seed=0):
        depth = resolve_serving_knobs(queue_depth=queue_depth)
        knobs = _resolve_deadline_knobs()
        self._deadline_default_s = knobs["deadline_default_ms"] / 1e3
        self._admit_min_s = knobs["deadline_admit_min_ms"] / 1e3
        self.drain_rate = DrainRateEstimator(knobs["shed_retry_floor_s"],
                                             knobs["shed_retry_cap_s"])
        self.engine = engine
        self.device = engine.device
        self.eos_id = eos_id
        self.default_max_new_tokens = int(default_max_new_tokens)
        self._seed = int(seed)
        self._first_draws = 0
        self._megastep_k = int(getattr(engine, "megastep_k", 1))
        self._ms_inflight = None     # a chained megastep not yet synced
        self._last_result_t = None   # when the last decode result landed
        self._step_ewma_s = None     # observed wall seconds per trip
        self._q = queue.Queue(maxsize=depth)
        self._held = None        # (req, since): page-pressure hold
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
    def retry_after_hint(self):
        """Drain-rate-derived Retry-After (seconds) for the backlog."""
        return self.drain_rate.retry_after(self._q.qsize() + self._n_active)

    def submit(self, prompt, max_new_tokens=None, temperature=0.0,
               trace=None, deadline_ms=None):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        budget = int(self.default_max_new_tokens if max_new_tokens is None
                     else max_new_tokens)
        if budget < 1:
            raise ValueError("max_new_tokens must be >= 1")
        temperature = float(temperature)
        if not (np.isfinite(temperature) and temperature >= 0):
            raise ValueError("temperature must be finite and >= 0 (got %r)"
                             % temperature)
        if not self.engine.fits_ever(prompt.size, budget):
            # a permanent misfit is a client error (400), not overload
            raise ValueError(
                "request worst case (prompt %d + max_new_tokens %d at "
                "FLAGS_kv_page_size=%d) exceeds the page pool "
                "(FLAGS_kv_num_pages=%d)"
                % (prompt.size, budget, self.engine.page_size,
                   self.engine.num_pages))
        pending = PendingResult(trace=trace)
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
                 timeout=None, trace=None, deadline_ms=None):
        """Blocking submit → wait."""
        return self.submit(prompt, max_new_tokens, temperature, trace=trace,
                           deadline_ms=deadline_ms).wait(timeout)

    def queue_depth(self):
        return self._q.qsize()

    def active_slots(self):
        """Slots currently decoding (the live /metrics gauge)."""
        return self._n_active

    def held_depth(self):
        """Requests held at the queue head for pages (0 or 1)."""
        return 0 if self._held is None else 1

    def residue(self):
        """Work still in flight: queued, held and decoding requests."""
        return {"queued": self._q.qsize(), "held": self.held_depth(),
                "active_slots": self._n_active}

    def close(self, timeout=None):
        """Graceful drain: stop admitting, decode every queued and
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
        if state.prefill_stats:
            summary["prefix_hit_pages"] = \
                state.prefill_stats.get("prefix_hit_pages", 0)
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

    def _finish(self, slot, state, reason, slots):
        self.engine.release(slot)
        del slots[slot]
        self.drain_rate.note_finish()
        summary = self._account_done(state, reason)
        state.pending._resolve({
            "tokens": [int(t) for t in state.generated],
            "finish_reason": reason, "n_prompt": state.prompt_len,
            "slo": summary})

    def _doa_admission(self, req, stage="admission"):
        """504 a request whose deadline (minus the admit margin) passed
        while it waited — BEFORE any prefill is spent on it."""
        pending, prompt, budget, temperature = req
        catalog.DEADLINE_EXCEEDED.inc(stage=stage)
        self._account_done(_SlotState(pending, prompt, budget, temperature),
                           "deadline")
        pending._fail(DeadlineExceededError(
            "deadline exceeded before admission (%s) — rejected without "
            "a prefill" % stage))

    def _sweep_held_deadline(self):
        if self._held is None:
            return
        req = self._held[0]
        dl = req[0].deadline
        if dl is not None and time.perf_counter() + self._admit_min_s > dl:
            self._held = None
            self._doa_admission(req, stage="held")

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
            self.engine.release(s)
            del slots[s]
            self.drain_rate.note_finish()
            self._account_done(st, "deadline")
            st.pending._fail(DeadlineExceededError(
                "deadline exceeded after %d generated tokens — slot "
                "evicted between decode steps" % len(st.generated)))
        self._n_active = len(slots)

    def _admit(self, slot, req, slots, hold_ms=0.0):
        pending, prompt, budget, temperature = req
        state = _SlotState(pending, prompt, budget, temperature)
        state.hold_ms = hold_ms
        if pending.trace is not None:
            tracing.span_from(pending.t_enqueue, "gen.queue_wait",
                              ctx=pending.trace, slot=slot)
        t0 = time.perf_counter()
        try:
            with tracing.use(pending.trace):
                # reserve exactly this request's worst case, not max_len
                logits = self.engine.prefill(slot, prompt,
                                             max_new_tokens=budget)
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
        state.prefill_stats = dict(self.engine.last_prefill_stats)
        try:
            catalog.GENERATION_PREFILLS.inc()
            catalog.GENERATION_PREFILL_MS.observe(
                (time.perf_counter() - t0) * 1e3)
            # token k occupies cache position prompt_len + k - 1
            state.budget = min(budget, self.engine.max_len -
                               int(self.engine.lengths[slot]))
            slots[slot] = state
            tok = self._sample_first(logits, temperature)
            catalog.GENERATION_TOKENS.inc()
            state.generated.append(tok)
            state.t_first = state.t_last = time.perf_counter()
            if self.eos_id is not None and tok == self.eos_id:
                self._finish(slot, state, "eos", slots)
            elif len(state.generated) >= state.budget:
                self._finish(slot, state, "length", slots)
            else:
                self.engine.set_input_token(slot, tok)
        except Exception as e:  # host-side bookkeeping: fail this request
            slots.pop(slot, None)
            self.engine.release(slot)
            self._account_done(state, "error", error=e)
            pending._fail(e)

    def _fail_cohort(self, slots, error):
        """Fail every in-flight sequence and free the slots; a lost pool
        state also resets the engine."""
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
            try:
                self.engine.release(s)
            except Exception:
                pass
            del slots[s]
        if isinstance(error, DeviceStateError):
            self.engine.reset()
        self._n_active = 0

    def _next_admission(self, slots, state, snap):
        """The next request to admit as ``(req, hold_ms)``, or None to
        stop admitting this iteration. A request that does not fit the
        free pages is held at the queue head (FIFO: nothing overtakes
        it) while the active slots keep decoding."""
        if self._held is not None:
            req, since = self._held
            if slots and not self.engine.can_admit(req[1], req[2],
                                                   snapshot=snap):
                return None
            self._held = None
            if req[0].trace is not None:
                tracing.span_from(since, "gen.hold", ctx=req[0].trace)
            return req, (time.perf_counter() - since) * 1e3
        while not state["saw_stop"]:
            try:
                # block only when fully idle
                item = self._q.get_nowait() if slots else self._q.get()
            except queue.Empty:
                return None
            if item is _STOP:
                state["saw_stop"] = True
                return None
            dl = item[0].deadline
            if dl is not None and \
                    time.perf_counter() + self._admit_min_s > dl:
                self._doa_admission(item)
                continue
            if slots and not self.engine.can_admit(item[1], item[2],
                                                   snapshot=snap):
                self._held = (item, time.perf_counter())
                return None
            return item, 0.0
        return None

    def _iterate(self, slots, state):
        """One scheduler iteration (admission + one decode step); returns
        True when the loop should exit."""
        self._evict_expired(slots)
        self._sweep_held_deadline()
        snap = self.engine.admission_state()
        while len(slots) < self.engine.max_slots:
            nxt = self._next_admission(slots, state, snap)
            if nxt is None:
                break
            self._admit(self.engine.free_slots()[0], nxt[0], slots,
                        hold_ms=nxt[1])
            snap = self.engine.admission_state()
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
            return state["saw_stop"] and self._held is None
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
        if self._megastep_k > 1 or self._ms_inflight is not None:
            k = self._clamp_k(slots)
            if k > 1 or self._ms_inflight is not None:
                return self._megastep_iterate(slots, state, k, t0, riders)
        # K = 1: one decode step across every active slot
        step_idx = self._step_idx
        self._step_idx += 1
        toks = self.engine.decode_step(temperatures=self._ms_temps(slots),
                                       seed=self._seed, step=step_idx)
        self._last_result_t = time.perf_counter()
        catalog.GENERATION_DECODE_STEP_MS.observe(
            (self._last_result_t - t0) * 1e3)
        catalog.GENERATION_DECODE_STEPS.inc()
        catalog.GENERATION_SLOT_OCCUPANCY.observe(len(slots))
        catalog.GENERATION_TOKENS.inc(float(len(slots)))
        tracing.span_from(t0, "gen.decode_step", ctx=None, step=step_idx,
                          n_slots=len(slots), request_ids=riders)
        now = time.perf_counter()
        for s, st in list(slots.items()):
            tok = int(toks[s])
            st.generated.append(tok)
            st.t_last = now
            st.decode_steps += 1
            if self.eos_id is not None and tok == self.eos_id:
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
        before the tightest deadline can pass. The reference's third
        term, K = 1 under SLO pressure, waits for the port's tenancy and
        SLO control."""
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
        with no admission work pending (empty queue, nothing held, not
        stopping), so a prefill never waits behind K more trips, and only
        when every tracked slot rode N (``riders``, checked by identity):
        a chained megastep inherits N's device live mask, so a slot
        admitted after N would never decode in it."""
        return (self._megastep_k > 1 and bool(slots) and
                not state["saw_stop"] and self._held is None and
                self._q.qsize() == 0 and
                all(riders.get(s) is st for s, st in slots.items()))

    def _megastep_iterate(self, slots, state, k, t0, riders_ids):
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
                          request_ids=riders_ids)
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
        return False

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
