"""Disaggregated serving on the port against the JAX reference on the CPU,
at the reference fixture's tiny decoder (tests/serving/test_disagg.py:
vocab 64, dim 32, 2 heads, 2 layers, page 8), carried across by
``convert.params_from_jax``:

* the wire form (``serving.kv_transfer``): round trip, a torn entry
  invisible, a corrupt one detected, a geometry mismatch naming the field,
  knob errors naming the flag as the reference's do;
* entries cross between the packages in both directions: a JAX export
  adopted by a port engine and a port export read by the JAX
  ``read_prefix(expect=)`` and adopted by the JAX engine — pages bitwise in
  fp32, bf16, int8 and fp8 (with their scales), fp32 greedy streams
  token-identical to the exporting package's;
* every failed import (torn, corrupt, geometry-mismatched, scale-less)
  degrades to self-prefill and leaves the pool as it was; a full pool
  leaves nothing half-adopted; an adoption keeps every pool tensor's
  ``data_ptr()`` (captured megastep trips hold those addresses);
* the ``PrefillWorker``, the tier store's LRU with a leased entry spared and
  its restart from disk, the tier server's endpoints, the client's breaker
  with the direct-disk fallback, the scheduler's ``imported_pages`` and
  ``POST /v1/prefill`` through ``make_server``.

K3 and K3-quant read imported pages like any other; chip_smoke.py phase 18
holds that on the card.
"""

from tests import torch_threads  # noqa: F401  (first)
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu import serving as jserving
from paddle_tpu.serving import kv_transfer as jkv
from paddle_tpu.serving import registry as jregistry
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.observability import catalog
from paddle_tpu_torch.serving import generation as pgen
from paddle_tpu_torch.serving import kv_transfer
from paddle_tpu_torch.serving.kv_transfer import (PrefillWorker,
                                                  TornTransferError,
                                                  TransferError,
                                                  resolve_kv_transfer_knobs)
from paddle_tpu_torch.serving.paged_kv import (PagedDecodeEngine,
                                               PoolExhaustedError)
from paddle_tpu_torch.serving.prefix_tier import (PrefixTierClient,
                                                  PrefixTierStore,
                                                  make_tier_server)
from paddle_tpu_torch.serving.registry import resolve_fleet_knobs
from paddle_tpu_torch.serving.server import make_server

VOCAB, DIM, HEADS, LAYERS, PAGE = 64, 32, 2, 2, 8
PROMPT = list(range(1, 30))  # 3 full pages + a partial tail at page 8
NEW = 8
MODES = ("fp32", "bf16", "int8", "fp8")


def _np_tree(params):
    return {k: ([{n: np.asarray(a) for n, a in b.items()} for b in v]
                if k == "blocks" else np.asarray(v))
            for k, v in params.items()}


@pytest.fixture(scope="module")
def decoders():
    """The fixture's decoder in both packages, fp32 and bf16."""
    jm = jserving.TransformerDecoderModel(vocab_size=VOCAB, dim=DIM,
                                          n_heads=HEADS, n_layers=LAYERS)
    jp = jm.init_params(0)
    jm16 = jserving.TransformerDecoderModel(
        vocab_size=VOCAB, dim=DIM, n_heads=HEADS, n_layers=LAYERS,
        dtype=jnp.bfloat16)
    import jax
    jp16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    pm = pgen.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                      n_layers=LAYERS)
    pp = params_from_jax(_np_tree(jp), device="cpu")
    pm16 = pgen.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                        n_layers=LAYERS,
                                        dtype=torch.bfloat16)
    pp16 = {k: ([{n: t.to(torch.bfloat16) for n, t in b.items()}
                 for b in v] if k == "blocks" else v.to(torch.bfloat16))
            for k, v in pp.items()}
    return {"jax": {"fp32": (jm, jp), "bf16": (jm16, jp16)},
            "port": {"fp32": (pm, pp), "bf16": (pm16, pp16)}}


def _quant(mode):
    return mode if mode in ("int8", "fp8") else "off"


def _model(decoders, pkg, mode):
    return decoders[pkg]["bf16" if mode == "bf16" else "fp32"]


def _engine(decoders, mode="fp32", tier=None, num_pages=32, max_slots=4):
    model, params = _model(decoders, "port", mode)
    return PagedDecodeEngine(model, params, max_slots=max_slots,
                             max_len=64, prefill_buckets=(16, 32),
                             page_size=PAGE, num_pages=num_pages,
                             kv_quant_dtype=_quant(mode), prefix_tier=tier,
                             device="cpu")


def _jax_engine(decoders, mode="fp32", tier=None):
    model, params = _model(decoders, "jax", mode)
    return jserving.PagedDecodeEngine(
        model, params, max_slots=4, max_len=64, prefill_buckets=(16, 32),
        page_size=PAGE, num_pages=32, kv_quant_dtype=_quant(mode),
        prefix_tier=tier)


def _client(root, url=""):
    return PrefixTierClient(store_root=str(root), tier_url=url)


def _keys(prompt=PROMPT, n=None):
    return kv_transfer.chain_keys(prompt, PAGE,
                                  len(prompt) // PAGE if n is None else n)


def _publish_via_engine(decoders, root, mode="fp32", prompt=PROMPT):
    """Prefill ``prompt`` on a throwaway port engine and publish it
    synchronously; returns the final chain key hex."""
    eng = _engine(decoders, mode)
    eng.prefill(0, prompt, max_new_tokens=1)
    keys = _keys(prompt)
    _client(root).publish_now(eng, keys, eng._slot_pages[0][:len(keys)])
    return keys[-1].hex()


def _bytes(x):
    """The raw bytes of a tensor or a (JAX or ml_dtypes) array."""
    if torch.is_tensor(x):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.uint8).tobytes()


def _pool_state(eng):
    tensors = eng._kp + eng._vp + (eng._ks or []) + (eng._vs or [])
    return ([t.clone() for t in tensors], eng.pool.free_pages(),
            eng.pool.refs.copy(), len(eng.prefix_cache))


def _assert_pool_unchanged(eng, before):
    tensors, free, refs, n_cached = before
    now = eng._kp + eng._vp + (eng._ks or []) + (eng._vs or [])
    assert all(_bytes(a) == _bytes(b) for a, b in zip(tensors, now))
    assert eng.pool.free_pages() == free and len(eng.prefix_cache) == n_cached
    np.testing.assert_array_equal(eng.pool.refs, refs)


# ---------------------------------------------------------------------------
# wire form
# ---------------------------------------------------------------------------

def test_export_read_roundtrip(decoders, tmp_path):
    eng = _engine(decoders)
    eng.prefill(0, PROMPT, max_new_tokens=1)
    ks, vs, kss, vss = eng.export_pages(eng._slot_pages[0][:3])
    assert kss is None and vss is None
    meta = {"keys": [k.hex() for k in _keys()]}
    meta.update(eng.geometry())
    path = kv_transfer.export_prefix(str(tmp_path), meta, ks, vs)
    assert os.path.isfile(os.path.join(path, "_MANIFEST"))
    meta2, ks2, vs2, _, _ = kv_transfer.read_prefix(
        path, expect=eng.geometry())
    assert meta2["keys"] == meta["keys"]
    for a, b in zip(ks + vs, ks2 + vs2):
        assert _bytes(a) == _bytes(b)
    assert kv_transfer.find_committed(str(tmp_path),
                                      meta["keys"][-1]) == path
    # max_pages maps only the leading pages a shorter chain matches
    _, ks3, _, _, _ = kv_transfer.read_prefix(path, max_pages=2)
    assert ks3[0].shape[0] == 2


def test_torn_entry_invisible(decoders, tmp_path):
    key = _publish_via_engine(decoders, tmp_path)
    path = kv_transfer.find_committed(str(tmp_path), key)
    os.unlink(os.path.join(path, "_MANIFEST"))
    assert kv_transfer.find_committed(str(tmp_path), key) is None
    with pytest.raises(TornTransferError):
        kv_transfer.read_prefix(path)


def test_corrupt_entry_detected(decoders, tmp_path):
    key = _publish_via_engine(decoders, tmp_path)
    path = kv_transfer.find_committed(str(tmp_path), key)
    with open(os.path.join(path, "pages.npz"), "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\xff" * 8)
    with pytest.raises(TransferError) as ei:
        kv_transfer.read_prefix(path)
    assert "verification" in str(ei.value)


@pytest.mark.parametrize("field,value", [("page_size", 16),
                                         ("dtype", "bfloat16"),
                                         ("kv_quant_group", 4)])
def test_geometry_mismatch_names_the_field(decoders, tmp_path, field,
                                           value):
    key = _publish_via_engine(decoders, tmp_path)
    path = kv_transfer.find_committed(str(tmp_path), key)
    want = _engine(decoders).geometry()
    want[field] = value
    with pytest.raises(TransferError) as ei:
        kv_transfer.read_prefix(path, expect=want)
    assert "%s=" % field in str(ei.value)
    with pytest.raises(jkv.TransferError) as ref:
        jkv.read_prefix(path, expect=want)
    assert str(ei.value) == str(ref.value)


@pytest.mark.parametrize("call", [
    lambda m: m.resolve_kv_transfer_knobs(min_pages=0),
    lambda m: m.resolve_kv_transfer_knobs(min_pages="x"),
    lambda m: m.resolve_kv_transfer_knobs(transfer_dir=123),
    lambda m: m.resolve_kv_transfer_knobs(weight_quant_dtype="int4",
                                          which=("weight_quant_dtype",)),
    lambda m: m.resolve_kv_transfer_knobs(which=("nope",)),
])
def test_kv_transfer_knob_errors_match_the_reference(call):
    with pytest.raises(ValueError) as ref:
        call(jkv)
    with pytest.raises(ValueError) as got:
        call(kv_transfer)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("kw", [
    {"prefix_tier_timeout_s": 0, "which": ("prefix_tier_timeout_s",)},
    {"prefix_tier_capacity_mb": 0, "which": ("prefix_tier_capacity_mb",)},
    {"prefix_tier_url": 7, "which": ("prefix_tier_url",)},
])
def test_tier_knob_errors_match_the_reference(kw):
    with pytest.raises(ValueError) as ref:
        jregistry.resolve_fleet_knobs(**kw)
    with pytest.raises(ValueError) as got:
        resolve_fleet_knobs(**kw)
    assert str(got.value) == str(ref.value)
    names = ("prefix_tier_url", "prefix_tier_timeout_s",
             "prefix_tier_capacity_mb")
    assert resolve_fleet_knobs(which=names) == \
        jregistry.resolve_fleet_knobs(which=names)
    assert resolve_kv_transfer_knobs() == jkv.resolve_kv_transfer_knobs()


# ---------------------------------------------------------------------------
# across the packages, both directions
# ---------------------------------------------------------------------------

def _jax_rows(jeng, pids):
    idx = np.asarray(pids, np.int64)
    rows = [np.asarray(p[idx]) for p in jeng._kp + jeng._vp]
    if jeng.kv_quant is not None:
        rows += [np.asarray(s[idx]) for s in jeng._ks + jeng._vs]
    return rows


def _port_rows(eng, pids):
    idx = torch.tensor(pids, dtype=torch.long)
    tensors = eng._kp + eng._vp + (eng._ks or []) + (eng._vs or [])
    return [t.index_select(0, idx) for t in tensors]


@pytest.mark.parametrize("mode", MODES)
def test_jax_export_adopted_by_the_port(decoders, tmp_path, mode):
    jeng = _jax_engine(decoders, mode)
    jeng.prefill(0, PROMPT, max_new_tokens=1)
    keys = _keys()
    pids = list(jeng._slot_pages[0][:3])
    exported = _jax_rows(jeng, pids)
    jserving.PrefixTierClient(store_root=str(tmp_path),
                              tier_url="").publish_now(jeng, keys, pids)
    eng = _engine(decoders, mode, tier=_client(tmp_path))
    assert eng.geometry() == jeng.geometry()
    before = catalog.KV_TRANSFER_PAGES_IMPORTED.value()
    if mode == "fp32":
        jeng.release(0)
        jeng.reset()
        ref = jserving.greedy_generate(jeng, [PROMPT], NEW)
        assert pgen.greedy_generate(eng, [PROMPT], NEW) == ref
    else:
        eng.prefill(0, PROMPT, max_new_tokens=NEW)
    assert eng.last_prefill_stats["imported_pages"] == 3
    assert catalog.KV_TRANSFER_PAGES_IMPORTED.value() - before == 3
    _, cached = eng.prefix_cache.match(PROMPT, 3)
    got = _port_rows(eng, cached)
    assert [_bytes(a) for a in got] == [_bytes(b) for b in exported]


@pytest.mark.parametrize("mode", MODES)
def test_port_export_read_and_adopted_by_jax(decoders, tmp_path, mode):
    eng = _engine(decoders, mode)
    ref = pgen.greedy_generate(eng, [PROMPT], NEW) if mode == "fp32" \
        else None
    eng.reset()
    eng.prefill(0, PROMPT, max_new_tokens=1)
    keys = _keys()
    pids = list(eng._slot_pages[0][:3])
    path = _client(tmp_path).publish_now(eng, keys, pids)
    exported = [_bytes(t) for t in _port_rows(eng, pids)]
    jeng = _jax_engine(decoders, mode)
    _, ks, vs, kss, vss = jkv.read_prefix(path, expect=jeng.geometry())
    arrays = ks + vs + (kss + vss if kss is not None else [])
    assert [_bytes(a) for a in arrays] == exported
    if mode == "fp32":
        jeng.prefix_tier = jserving.PrefixTierClient(
            store_root=str(tmp_path), tier_url="")
        assert jserving.greedy_generate(jeng, [PROMPT], NEW) == ref
        assert jeng.last_prefill_stats["imported_pages"] == 3
    else:
        jeng.adopt_prefix(keys, ks, vs, k_scales=kss, v_scales=vss)
    _, cached = jeng.prefix_cache.match(PROMPT, 3)
    assert [_bytes(a) for a in _jax_rows(jeng, cached)] == exported


# ---------------------------------------------------------------------------
# degradation: every failed import is a self-prefill over an unchanged pool
# ---------------------------------------------------------------------------

def _tear(path):
    os.unlink(os.path.join(path, "_MANIFEST"))


def _corrupt(path):
    with open(os.path.join(path, "pages.npz"), "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\xff" * 8)


def _strip_scales(path):
    """Rewrite an int8 entry's payload without its scales, re-committed
    (a well-formed entry a quantized engine must still refuse)."""
    from paddle_tpu_torch.io import _checkpoint_manifest
    with np.load(os.path.join(path, "pages.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files if not k.startswith(
            ("ks", "vs"))}
    np.savez(os.path.join(path, "pages.npz"), **arrays)
    with open(os.path.join(path, "_MANIFEST")) as f:
        manifest = json.load(f)
    manifest["md5"] = _checkpoint_manifest(path)
    with open(os.path.join(path, "_MANIFEST"), "w") as f:
        json.dump(manifest, f)


@pytest.mark.parametrize("fault,mode,outcome", [
    ("torn", "fp32", None), ("corrupt", "fp32", "invalid"),
    ("geometry", "fp32", "invalid"), ("scaleless", "int8", "invalid")])
def test_failed_import_self_prefills_over_an_unchanged_pool(
        decoders, tmp_path, fault, mode, outcome):
    if fault == "geometry":     # a bf16 entry offered to an fp32 engine
        key = _publish_via_engine(decoders, tmp_path, "bf16")
    else:
        key = _publish_via_engine(decoders, tmp_path, mode)
    path = kv_transfer.find_committed(str(tmp_path), key)
    {"torn": _tear, "corrupt": _corrupt, "geometry": lambda p: None,
     "scaleless": _strip_scales}[fault](path)
    eng = _engine(decoders, mode, tier=_client(tmp_path))
    eng.auto_publish = False
    before = _pool_state(eng)
    count = None if outcome is None else \
        catalog.KV_TRANSFER_IMPORTS.value(outcome=outcome)
    keys, pids, known, imported = eng._extend_from_tier(
        np.asarray(PROMPT, np.int32), len(PROMPT), [], [])
    assert (keys, pids, imported) == ([], [], 0)
    _assert_pool_unchanged(eng, before)
    if outcome is not None:
        assert catalog.KV_TRANSFER_IMPORTS.value(outcome=outcome) == \
            count + 1
    # the torn entry is invisible: a miss, not an import attempt
    assert known == (0 if fault == "torn" else 3)
    ref = pgen.greedy_generate(_engine(decoders, mode), [PROMPT], NEW)
    assert pgen.greedy_generate(eng, [PROMPT], NEW) == ref
    assert eng.last_prefill_stats["imported_pages"] == 0


def test_quantized_engine_refuses_pages_without_scales(decoders):
    eng = _engine(decoders, "int8")
    before = _pool_state(eng)
    pages = [torch.zeros(2, PAGE, HEADS, DIM // HEADS, dtype=torch.int8)]
    with pytest.raises(TransferError, match="without their scales"):
        eng.adopt_prefix([b"k0", b"k1"], pages * LAYERS, pages * LAYERS)
    bad = [torch.zeros(2, 3, HEADS)] * LAYERS     # G is 1 at group 0
    with pytest.raises(TransferError, match="scale array has shape"):
        eng.adopt_prefix([b"k0", b"k1"], pages * LAYERS, pages * LAYERS,
                         k_scales=bad, v_scales=bad)
    _assert_pool_unchanged(eng, before)


def test_full_pool_leaves_nothing_half_adopted(decoders):
    eng = _engine(decoders, num_pages=8)
    # 29 prompt + 19 budget = 6 pages reserved; the 3 cached full pages
    # are slot-shared (refs 2), so nothing is evictable
    eng.prefill(0, PROMPT, max_new_tokens=19)
    before = _pool_state(eng)
    free = eng.pool.free_pages()
    shape = (free + 1, PAGE, HEADS, DIM // HEADS)
    with pytest.raises(PoolExhaustedError):
        eng.adopt_prefix([b"k%d" % i for i in range(free + 1)],
                         [torch.ones(shape)] * LAYERS,
                         [torch.ones(shape)] * LAYERS)
    _assert_pool_unchanged(eng, before)
    with pytest.raises(TransferError, match="page array has shape"):
        eng.adopt_prefix([b"k"], [torch.zeros(1, 4, HEADS, 16)] * LAYERS,
                         [torch.zeros(1, 4, HEADS, 16)] * LAYERS)
    _assert_pool_unchanged(eng, before)


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_adoption_keeps_the_pool_tensors(decoders, mode):
    src = _engine(decoders, mode)
    src.prefill(0, PROMPT, max_new_tokens=1)
    ks, vs, kss, vss = src.export_pages(src._slot_pages[0][:3])
    eng = _engine(decoders, mode)
    tensors = eng._kp + eng._vp + (eng._ks or []) + (eng._vs or [])
    ptrs = [t.data_ptr() for t in tensors]
    assert eng.adopt_prefix(_keys(), ks, vs, k_scales=kss,
                            v_scales=vss) == 3
    now = eng._kp + eng._vp + (eng._ks or []) + (eng._vs or [])
    assert [t.data_ptr() for t in now] == ptrs
    assert all(a is b for a, b in zip(tensors, now))
    _, cached = eng.prefix_cache.match(PROMPT, 3)
    assert [_bytes(t) for t in _port_rows(eng, cached)] == \
        [_bytes(t) for t in _port_rows(src, src._slot_pages[0][:3])]
    # a chain the cache already holds keeps its pages; the dupes go back
    free = eng.pool.free_pages()
    assert eng.adopt_prefix(_keys(), ks, vs, k_scales=kss,
                            v_scales=vss) == 3
    assert eng.pool.free_pages() == free
    assert eng.prefix_cache.match(PROMPT, 3)[1] == cached


# ---------------------------------------------------------------------------
# the prefill worker, the tier store / server / client
# ---------------------------------------------------------------------------

def test_prefill_worker_roundtrip_and_skips_a_committed_chain(decoders,
                                                              tmp_path):
    eng = _engine(decoders, tier=_client(tmp_path))
    worker = PrefillWorker(eng, _client(tmp_path))
    assert eng.auto_publish is False
    res = worker.prefill(PROMPT)
    assert res["n_pages"] == 3 and res["n_tokens"] == len(PROMPT)
    assert kv_transfer.find_committed(str(tmp_path), res["key"])
    assert not eng.active.any()
    dec = _engine(decoders, tier=_client(tmp_path))
    out = pgen.greedy_generate(dec, [PROMPT], NEW)
    assert out == pgen.greedy_generate(_engine(decoders), [PROMPT], NEW)
    assert dec.last_prefill_stats["imported_pages"] == 3
    assert res["first_token"] == out[0][0]
    parent = os.path.join(str(tmp_path), res["key"][:2])
    worker.prefill(PROMPT)
    assert len(os.listdir(parent)) == 1      # no duplicate entry
    with pytest.raises(ValueError):
        PrefillWorker(pgen.DecodeEngine(
            *_model(decoders, "port", "fp32"), max_slots=2, max_len=64,
            prefill_buckets=(16,), device="cpu"), _client(tmp_path))
    with pytest.raises(ValueError):
        PrefillWorker(_engine(decoders), PrefixTierClient(store_root="",
                                                          tier_url=""))


def test_store_lru_spares_the_leased_entry_and_restarts_from_disk(
        decoders, tmp_path):
    clock = [0.0]
    eng = _engine(decoders)
    cli = _client(tmp_path)
    prompts = [[i] * 24 for i in (1, 2, 3)]
    for p in prompts:
        eng.reset()
        eng.prefill(0, p, max_new_tokens=1)
        cli.publish_now(eng, _keys(p), eng._slot_pages[0][:3])
    # a fresh store (a killed tier's replacement) re-indexes from disk
    store = PrefixTierStore(str(tmp_path), capacity_mb=64.0,
                            clock=lambda: clock[0])
    st = store.stats()
    assert st["entries"] == 3 and st["indexed_keys"] == 9
    k0 = [k.hex() for k in _keys(prompts[0])]
    assert store.lookup(k0[:2])["n_pages"] == 2   # an intermediate chain
    assert store.lookup(["ff" * 20]) is None
    held = store.lookup(k0)
    assert held is not None
    before = catalog.PREFIX_TIER_EVICTIONS.value()
    store.capacity_bytes = st["bytes"] // 3 + 1
    clock[0] += 1.0
    store.sweep()
    assert store.stats()["entries"] == 1
    assert store.lookup(k0)["n_pages"] == 3     # the leased one lives
    assert catalog.PREFIX_TIER_EVICTIONS.value() - before == 2
    clock[0] += 1e6                              # the lease expires
    store.capacity_bytes = 0
    store.sweep()
    assert store.stats()["entries"] == 0


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_tier_server_endpoints_partial_chains_and_leases(decoders,
                                                         tmp_path):
    _publish_via_engine(decoders, tmp_path)
    srv = make_tier_server(str(tmp_path), capacity_mb=64.0)
    srv.start_background()
    try:
        url = srv.url
        keys = [k.hex() for k in _keys()]
        status, doc = _post(url + "/v1/prefix/lookup", {"keys": keys})
        assert status == 200 and doc["n_pages"] == 3
        assert _post(url + "/v1/prefix/release", doc)[1] == {"ok": True}
        assert _post(url + "/v1/prefix/lookup",
                     {"keys": ["aa" * 20]})[0] == 404
        assert _post(url + "/v1/prefix/lookup", {"keys": "zz"})[0] == 400
        assert _post(url + "/v1/prefix/publish",
                     {"path": "/etc/passwd"})[0] == 400
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            h = json.loads(r.read())
        assert h["role"] == "cache" and h["ready"]
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            assert "prefix_tier_entries 1" in r.read().decode()
        # a different prompt sharing only the first 2 pages maps just those
        # (partial chains need the index), and hands its lease back
        other = PROMPT[:16] + [55, 56, 57, 58, 59]
        eng = _engine(decoders, tier=_client(tmp_path, url))
        out = pgen.greedy_generate(eng, [other], NEW)
        assert out == pgen.greedy_generate(_engine(decoders), [other], NEW)
        assert eng.last_prefill_stats["imported_pages"] == 2
        assert all(not e.leases for e in srv.store._entries.values())
    finally:
        srv.stop(2.0)


def test_client_breaker_and_disk_fallback(decoders, tmp_path):
    _publish_via_engine(decoders, tmp_path)
    cli = PrefixTierClient(store_root=str(tmp_path),
                           tier_url="http://127.0.0.1:9", timeout_s=0.2,
                           fail_threshold=2, backoff_s=60.0)
    keys = [k.hex() for k in _keys()]
    before = catalog.PREFIX_TIER_REQUESTS.value(op="lookup",
                                                outcome="disk")
    assert cli.lookup_chain(keys)["n_pages"] == 3
    assert cli.lookup_chain(keys) is not None
    assert not cli._server_available()           # the breaker opened
    t0 = time.perf_counter()
    assert cli.lookup_chain(keys) is not None
    assert time.perf_counter() - t0 < 0.15       # no connect attempt
    assert catalog.PREFIX_TIER_REQUESTS.value(
        op="lookup", outcome="disk") - before == 3
    # a cold prefill publishes through the async queue; close() drains it
    one = [7] * 17
    eng = _engine(decoders, tier=cli)
    eng.prefill(0, one, max_new_tokens=2)
    cli.close()
    assert kv_transfer.find_committed(str(tmp_path),
                                      _keys(one)[-1].hex()) is not None


def test_scheduler_reports_imported_pages(decoders, tmp_path):
    _publish_via_engine(decoders, tmp_path)
    eng = _engine(decoders, tier=_client(tmp_path))
    sched = pgen.GenerationScheduler(eng, default_max_new_tokens=6)
    try:
        res = sched.generate(PROMPT, timeout=30)
        assert res["slo"]["imported_pages"] == 3
        assert res["slo"]["prefix_hit_pages"] == 3
        res = sched.generate([9] * 12, timeout=30)
        assert "imported_pages" not in res["slo"]
    finally:
        sched.close(10)


def test_v1_prefill_through_make_server(decoders, tmp_path):
    eng = _engine(decoders, tier=_client(tmp_path))
    server = make_server(None, prefill_worker=PrefillWorker(
        eng, _client(tmp_path))).start_background()
    bare = make_server(None, generator=pgen.GenerationScheduler(
        _engine(decoders))).start_background()
    try:
        status, doc = _post(server.url + "/v1/prefill", {"prompt": PROMPT})
        assert status == 200 and doc["n_pages"] == 3
        assert doc["key"] == _keys()[-1].hex() and doc["request_id"]
        assert doc["latency_ms"] > 0 and doc["n_tokens"] == len(PROMPT)
        assert _post(server.url + "/v1/prefill",
                     {"prompt": [True]})[0] == 400
        assert _post(server.url + "/v1/prefill",
                     {"prompt": [1] * 40})[0] == 400   # > the buckets
        assert _post(server.url + "/v1/generate",
                     {"prompt": PROMPT})[0] == 404
        assert _post(bare.url + "/v1/prefill", {"prompt": PROMPT})[0] == 404
        # a pool another slot holds whole: 503 with a Retry-After
        busy = _engine(decoders, num_pages=8)
        busy.prefill(1, [5] * 30, max_new_tokens=34)
        full = make_server(None, prefill_worker=PrefillWorker(
            busy, _client(tmp_path)))
        full.start_background()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(
                    full.url + "/v1/prefill",
                    data=json.dumps({"prompt": PROMPT}).encode(),
                    headers={"Content-Type": "application/json"}),
                    timeout=10)
            assert ei.value.code == 503
            assert int(ei.value.headers["Retry-After"]) >= 1
        finally:
            full.shutdown_gracefully(5.0)
    finally:
        server.shutdown_gracefully(5.0)
        bare.shutdown_gracefully(5.0)


def test_entry_points_default_to_the_card(decoders, tmp_path, monkeypatch):
    """``serve --role prefill|decode`` and a paged engine with a tier client
    run on the card unless asked for the CPU: without one they raise
    before serving anything."""
    from paddle_tpu_torch.serving import save_decoder, serve
    model, params = _model(decoders, "port", "fp32")
    d = str(tmp_path / "decoder")
    save_decoder(d, model, params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for role in ("prefill", "decode"):
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--generation-model", d, "--role", role,
                        "--kv-transfer-dir", str(tmp_path / "store"),
                        "--port", "0"])
    with pytest.raises(RuntimeError, match="cuda"):
        PagedDecodeEngine(model, params, max_slots=2, max_len=64,
                          prefill_buckets=(16,), page_size=PAGE,
                          prefix_tier=_client(tmp_path))
