"""KV-page handoff — the wire/disk form that moves prefilled pages
between processes; the port of ``paddle_tpu/serving/kv_transfer.py``.

Disaggregated serving splits one replica's work across failure domains:
a PREFILL worker computes a prompt's K/V pages, a DECODE worker maps
them into its own pool and generates, and a fleet-wide prefix-cache
tier (serving/prefix_tier.py) lets a prefix prefilled ANYWHERE be
reused EVERYWHERE. Every edge of that split can tear — a prefill
worker SIGKILLed mid-export, a receiver reading while the writer dies,
a half-copied store entry — so the wire form reuses the checkpoint
crash-consistency scheme (``paddle_tpu_torch/io.py``): page tensors are
written and fsynced FIRST, then an md5 ``_MANIFEST`` commits the entry,
and a reader verifies the digests before mapping a single page in. A
torn transfer is therefore INVISIBLE (no manifest) and a corrupt one is
DETECTED (md5 mismatch) — both degrade to the receiver prefilling the
prompt itself, never to garbage K/V in a live pool.

Store layout (one entry per published prefix, content-addressed by the
prompt's block-chain hash — the :class:`~.paged_kv.PrefixCache` key
scheme, so position-0-anchored chains only):

    <kv_transfer_dir>/<key[:2]>/<key>.<nonce>/
        meta.json     geometry + the per-block chain keys (hex)
        pages.npz     k0..k{L-1}, v0..v{L-1}: [n_pages, page_size,
                      heads, head_dim] pool rows per layer (ks*/vs*:
                      their fp32 scales [n_pages, G, heads] under
                      quantization)
        _MANIFEST     md5 commit record (io._commit_manifest)

The form is the reference's byte for byte, so an entry crosses between
the two packages in both directions. Page dtypes travel by the
reference's names (``float32``, ``bfloat16``, ``int8``,
``float8_e4m3fn``, ``float8_e5m2``); numpy has no bf16 or fp8, so those
payloads are stored as uint8 byte views (as the reference stores them)
and read back with ``torch.Tensor.view(dtype)``, bitwise. Page arrays
move as CPU ``torch`` tensors; nothing here touches a device.

``<nonce>`` makes concurrent publishers of the same prefix collision-
free (last committed entry wins at lookup; duplicates are eviction
fodder). Entries hold only FULL pages — the partial tail page is
recomputed by every consumer, which is what keeps the mapped pages
copy-on-write-safe (see paged_kv.PrefixCache).

:class:`PrefillWorker` is the prefill-role service half: it owns a
paged engine used only for prompt prefills, exports each prompt's full
pages to the store, publishes them to the tier index, and releases the
slot — the decode worker then maps the pages instead of recomputing
the prompt (serving/server.py routes ``POST /v1/prefill`` here).
"""

import hashlib
import json
import os
import threading
import time
import uuid

import numpy as np
import torch

from ..observability import catalog, tracing

__all__ = [
    "TransferError", "TornTransferError", "PrefillWorker",
    "chain_keys", "entry_bytes", "export_prefix", "find_committed",
    "read_prefix", "resolve_kv_transfer_knobs",
]

# the wire form's page dtype names (numpy's, as the reference writes
# them) and their torch dtypes
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int8": torch.int8,
           "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}
_NAMES = {v: k for k, v in _DTYPES.items()}


class TransferError(RuntimeError):
    """A committed handoff entry cannot be used: md5 verification
    failed, the payload is malformed, or its geometry (page size /
    layers / heads / dtype) does not match the receiving engine. The
    receiver discards the partial import and self-prefills."""


class TornTransferError(TransferError):
    """The entry was never committed (no ``_MANIFEST``) — the writer
    died mid-export. Invisible by design; receivers fall back."""


def dtype_name(dtype):
    """The wire form's name of a pool's torch dtype (the reference's
    ``np.dtype(pool_dtype).name``)."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise ValueError("no wire-form name for page dtype %s"
                         % dtype) from None


def resolve_kv_transfer_knobs(transfer_dir=None, min_pages=None,
                              weight_quant_dtype=None, which=None):
    """Resolve the ``FLAGS_kv_transfer_*`` knobs (explicit values win),
    validating each — errors name the flag. Returns a dict with the
    requested knobs: ``transfer_dir`` (str, "" = handoff disabled),
    ``min_pages`` (int >= 1: smallest prefix worth publishing, in full
    pages) and ``weight_quant_dtype`` (off|fp8|int8 — the artifact-publish
    weight quantization mode)."""
    from .. import flags
    _known = ("transfer_dir", "min_pages", "weight_quant_dtype")
    wanted = ("transfer_dir", "min_pages") if which is None \
        else tuple(which)
    unknown = [k for k in wanted if k not in _known]
    if unknown:
        raise ValueError("unknown kv_transfer knob(s) %r" % (unknown,))
    knobs = {}
    if "weight_quant_dtype" in wanted:
        from ..ops.kv_quant import WEIGHT_QUANT_DTYPES
        value = flags.weight_quant_dtype if weight_quant_dtype is None \
            else weight_quant_dtype
        if value not in WEIGHT_QUANT_DTYPES:
            raise ValueError(
                "FLAGS_weight_quant_dtype must be one of %s (got %r)"
                % ("|".join(WEIGHT_QUANT_DTYPES), value))
        knobs["weight_quant_dtype"] = value
    if "transfer_dir" in wanted:
        if transfer_dir is None:
            transfer_dir = flags.kv_transfer_dir
        if transfer_dir is not None and not isinstance(transfer_dir, str):
            raise ValueError(
                "FLAGS_kv_transfer_dir must be a directory path string "
                "(got %r)" % (transfer_dir,))
        knobs["transfer_dir"] = transfer_dir or ""
    if "min_pages" in wanted:
        explicit = min_pages is not None
        label = "min_pages" if explicit else "FLAGS_kv_transfer_min_pages"
        value = min_pages if explicit else flags.kv_transfer_min_pages
        try:
            v = int(value)
        except (TypeError, ValueError):
            raise ValueError("%s must be an integer (got %r)"
                             % (label, value)) from None
        if v < 1:
            raise ValueError("%s must be >= 1 (got %d)" % (label, v))
        knobs["min_pages"] = v
    return knobs


def chain_keys(prompt, page_size, n_blocks):
    """The content-address scheme shared by the local
    :class:`~.paged_kv.PrefixCache`, the store, and the tier index:
    the running sha1 over the prompt's leading token blocks. Returns
    ``n_blocks`` raw digests — digest ``i`` names the chain
    ``block_0..block_i`` (position-0-anchored, so only identical
    prefixes share a key)."""
    h = hashlib.sha1()
    keys = []
    prompt = np.asarray(prompt, np.int32)
    for b in range(int(n_blocks)):
        h.update(prompt[b * page_size:(b + 1) * page_size].tobytes())
        keys.append(h.digest())
    return keys


# ---------------------------------------------------------------------------
# store entries — write / discover / read
# ---------------------------------------------------------------------------

def _entry_parent(root, key_hex):
    return os.path.join(root, key_hex[:2])


def _npz_safe(arr):
    """A host array npz can hold: bf16 and fp8 payloads (which numpy
    cannot represent) as uint8 byte views — the reference's form; the
    reader reinterprets them from the entry's geometry meta. Bitwise
    either way."""
    if torch.is_tensor(arr):
        arr = arr.detach().cpu().contiguous()
        if arr.dtype not in (torch.float32, torch.float16, torch.int8,
                             torch.uint8):
            arr = arr.view(torch.uint8)
        return arr.numpy()
    return np.asarray(arr)


def export_prefix(root, meta, k_layers, v_layers, k_scales=None,
                  v_scales=None):
    """Commit one prefix entry under ``root``: page tensors + meta
    fsynced first, then the md5 ``_MANIFEST`` (io._commit_manifest) —
    a crash anywhere before the manifest leaves a torn dir no reader
    ever maps. ``meta`` must carry ``keys`` (hex chain digests,
    longest last), ``page_size``, ``n_layers``, ``n_heads``,
    ``head_dim``, ``dtype``; ``k_layers``/``v_layers`` are per-layer
    host tensors (or numpy arrays) [n_pages, page_size, heads,
    head_dim]. QUANTIZED pages (meta ``kv_quant_dtype`` != "off")
    additionally carry their per-(page, group, kv-head) fp32 scales
    (``k_scales``/``v_scales``, [n_pages, G, heads] per layer) — the
    pages travel RAW in the storage dtype, so a tier transit is bitwise.
    Returns the committed entry path."""
    from ..io import _checkpoint_manifest, _commit_manifest, _fsync_path
    from ..robustness import chaos
    key_hex = meta["keys"][-1]
    parent = _entry_parent(root, key_hex)
    os.makedirs(parent, exist_ok=True)
    cur = os.path.join(parent, "%s.%s" % (key_hex, uuid.uuid4().hex[:8]))
    os.makedirs(cur)
    t0 = time.perf_counter()
    with open(os.path.join(cur, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    arrays = {}
    for i, (k, v) in enumerate(zip(k_layers, v_layers)):
        arrays["k%d" % i] = _npz_safe(k)
        arrays["v%d" % i] = _npz_safe(v)
    if k_scales is not None:
        for i, (ks, vs) in enumerate(zip(k_scales, v_scales)):
            arrays["ks%d" % i] = np.asarray(_npz_safe(ks), np.float32)
            arrays["vs%d" % i] = np.asarray(_npz_safe(vs), np.float32)
    np.savez(os.path.join(cur, "pages.npz"), **arrays)
    _fsync_path(os.path.join(cur, "pages.npz"), strict=True)
    # chaos point: a SIGKILL/hang here is the mid-handoff crash —
    # data written, manifest NOT committed, so the entry is torn and
    # invisible (FLAGS_chaos_spec "handoff:<sel>=<action>")
    chaos.maybe_fire("handoff")
    manifest = {"timestamp": time.time(),
                "n_pages": len(meta["keys"]),
                "md5": _checkpoint_manifest(cur)}
    _commit_manifest(parent, cur, manifest)
    catalog.KV_TRANSFER_EXPORTS.inc()
    tracing.span_from(t0, "kv.transfer_export", key=key_hex[:12],
                      pages=len(meta["keys"]))
    return cur


def find_committed(root, key_hex):
    """Newest COMMITTED entry dir for ``key_hex`` under ``root`` (the
    direct-disk discovery path used when the tier index is down), or
    None. Torn dirs (no ``_MANIFEST``) are skipped — they are either
    in-flight exports or a dead writer's leavings."""
    parent = _entry_parent(root, key_hex)
    try:
        names = [n for n in os.listdir(parent)
                 if n.startswith(key_hex + ".")]
    except OSError:
        return None
    best, best_mtime = None, -1.0
    for n in names:
        cur = os.path.join(parent, n)
        mpath = os.path.join(cur, "_MANIFEST")
        try:
            mtime = os.stat(mpath).st_mtime
        except OSError:
            continue
        if mtime > best_mtime:
            best, best_mtime = cur, mtime
    return best


def entry_bytes(path):
    """Payload size of one committed entry (store-capacity accounting)."""
    total = 0
    try:
        for fn in os.listdir(path):
            try:
                total += os.path.getsize(os.path.join(path, fn))
            except OSError:
                pass
    except OSError:
        pass
    return total


def _page_tensor(arr, dtype, path, name):
    """A stored payload as a CPU tensor of the entry's page dtype: taken
    as it is when numpy holds the dtype, else reinterpreted from its
    uint8 byte view (bitwise)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if t.dtype == dtype:
        return t
    if t.dtype != torch.uint8:
        raise TransferError(
            "handoff entry %s stores %s as %s, not as %s or its bytes"
            % (path, name, arr.dtype, _NAMES[dtype]))
    try:
        return t.view(dtype)
    except RuntimeError as e:
        raise TransferError("handoff entry %s: %s is no %s payload: %s"
                            % (path, name, _NAMES[dtype], e)) from None


def read_prefix(path, expect=None, max_pages=None):
    """Verify + load one committed entry. Returns ``(meta, k_layers,
    v_layers, k_scales, v_scales)`` — CPU tensors per layer, truncated
    to ``max_pages`` when given (a reader whose own chain matches only
    the first m blocks maps just those pages); the scale lists are None
    for full-precision entries. bf16 and fp8 payloads stored as uint8
    views are reinterpreted from the entry's declared dtype, so pages
    come back bitwise.

    Raises :class:`TornTransferError` when the entry was never
    committed, :class:`TransferError` on md5 failure, malformed
    payload, or — with ``expect`` (a geometry dict: page_size,
    n_layers, n_heads, head_dim, dtype, kv_quant_dtype,
    kv_quant_group) — a geometry mismatch naming the offending field.
    The caller must treat every one of these as "discard and
    self-prefill", never as request failure."""
    from ..io import _verify_serial
    try:
        manifest = _verify_serial(path)
    except (IOError, ValueError, OSError) as e:
        raise TransferError(
            "handoff entry %s fails verification: %s" % (path, e)) \
            from e
    if manifest is None:
        raise TornTransferError(
            "handoff entry %s was never committed (no _MANIFEST) — "
            "writer died mid-export" % path)
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        npz = np.load(os.path.join(path, "pages.npz"))
    except (OSError, ValueError) as e:
        raise TransferError(
            "handoff entry %s payload unreadable: %s" % (path, e)) from e
    quantized = meta.get("kv_quant_dtype", "off") not in (None, "off")
    page_dtype = _DTYPES.get(meta.get("dtype", "float32"))
    if page_dtype is None:
        raise TransferError(
            "handoff entry %s declares unknown page dtype %r"
            % (path, meta.get("dtype")))
    with npz:
        n_layers = int(meta.get("n_layers", -1))
        ks, vs, kss, vss = [], [], [], []
        try:
            for i in range(n_layers):
                ks.append(_page_tensor(npz["k%d" % i], page_dtype, path,
                                       "k%d" % i))
                vs.append(_page_tensor(npz["v%d" % i], page_dtype, path,
                                       "v%d" % i))
                if quantized:
                    kss.append(torch.from_numpy(np.asarray(
                        npz["ks%d" % i], np.float32)))
                    vss.append(torch.from_numpy(np.asarray(
                        npz["vs%d" % i], np.float32)))
        except KeyError as e:
            raise TransferError(
                "handoff entry %s is missing layer array %s"
                % (path, e)) from None
    if expect is not None:
        got = {"page_size": meta.get("page_size"),
               "n_layers": meta.get("n_layers"),
               "n_heads": meta.get("n_heads"),
               "head_dim": meta.get("head_dim"),
               "dtype": meta.get("dtype"),
               "kv_quant_dtype": meta.get("kv_quant_dtype", "off"),
               "kv_quant_group": meta.get("kv_quant_group", 0)}
        for field, want in expect.items():
            if got.get(field) != want:
                raise TransferError(
                    "handoff entry %s geometry mismatch: %s=%r but this "
                    "engine expects %r — refusing to map foreign pages"
                    % (path, field, got.get(field), want))
    if max_pages is not None:
        ks = [k[:max_pages] for k in ks]
        vs = [v[:max_pages] for v in vs]
        if quantized:
            kss = [s[:max_pages] for s in kss]
            vss = [s[:max_pages] for s in vss]
    if not quantized:
        return meta, ks, vs, None, None
    return meta, ks, vs, kss, vss


# ---------------------------------------------------------------------------
# Prefill worker — the prefill-role service half
# ---------------------------------------------------------------------------

class PrefillWorker:
    """One prefill-role process's engine owner: prefill the prompt on
    a :class:`~.paged_kv.PagedDecodeEngine`, publish its full pages to
    the store/tier, release the slot, answer with the chain key.

    The engine is NOT thread-safe, so prefills serialize on a lock —
    HTTP handler threads queue here; a prefill worker's concurrency is
    its process count. Publishing is SYNCHRONOUS (durable before the
    ack: the decode worker may look the key up the instant the response
    lands); the engine's own prefix cache still makes repeated popular
    prompts a map-not-compute on this side too."""

    def __init__(self, engine, publisher, eos_id=None):
        if not hasattr(engine, "page_size"):
            raise ValueError("PrefillWorker needs a paged engine "
                             "(serve --gen-paged is implied by --role "
                             "prefill)")
        if publisher is None or not publisher.store_root:
            raise ValueError(
                "PrefillWorker needs a store to publish into — set "
                "FLAGS_kv_transfer_dir (serve --kv-transfer-dir)")
        self.engine = engine
        # the worker publishes synchronously below — exactly once per
        # prefill; the engine's own async publisher must not race it
        # with duplicate store entries
        engine.auto_publish = False
        self.publisher = publisher
        self.eos_id = eos_id
        self._lock = threading.Lock()

    def prefill(self, prompt, trace=None):
        """Prefill ``prompt``, publish its full pages, release the
        slot. Returns ``{"key": <hex>, "n_pages": m, "n_tokens": n,
        "first_token": t}`` — the decode worker maps the pages by key
        and recomputes only the partial tail. Validation errors
        (overlong prompt, bad ids) raise ValueError; pool pressure
        raises PoolExhaustedError (503 upstream)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        engine = self.engine
        full = prompt.size // engine.page_size
        t0 = time.perf_counter()
        with self._lock, tracing.use(trace):
            # budget 1: a prefill-only slot reserves the prompt's pages
            # plus a single token, not a generation's worst case
            logits = engine.prefill(0, prompt, max_new_tokens=1)
            try:
                key_hex = None
                if full >= 1:
                    keys = chain_keys(prompt, engine.page_size, full)
                    key_hex = keys[-1].hex()
                    # publish only chains the store does not already
                    # hold — the store itself is the dedup authority
                    if find_committed(self.publisher.store_root,
                                      key_hex) is None:
                        self.publisher.publish_now(
                            engine, keys,
                            engine._slot_pages[0][:full])
            finally:
                engine.release(0)
        with tracing.use(trace):
            tracing.span_from(t0, "handoff.prefill_work",
                              n_tokens=int(prompt.size),
                              n_pages=int(full),
                              key="" if key_hex is None
                              else key_hex[:12])
        return {"key": key_hex, "n_pages": int(full),
                "n_tokens": int(prompt.size),
                "first_token": int(np.argmax(logits))}
