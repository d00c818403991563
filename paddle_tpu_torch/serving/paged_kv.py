"""Paged KV cache with shared-prefix reuse — the memory tier under the
port's generation engine; a port of ``paddle_tpu/serving/paged_kv.py``
(PagedAttention, Kwon et al. 2023).

  page pool    — ONE ``[num_pages + 1 scratch, page_size, heads,
                 head_dim]`` tensor per layer for K and one for V; a
                 sequence owns ceil((prompt + budget) / page_size) pages.
  page tables  — per-slot ``[max_pages]`` int32 rows mapping logical
                 positions to pool pages; unused entries point at the
                 SCRATCH page (the pool's last row), and the host
                 redirects every write that must not land (inactive
                 slots, padded prefill tails) to scratch, whose contents
                 are finite and always masked.
  prefix cache — refcounted, content-addressed map from hashed
                 prompt-block chains to pages holding their K/V; requests
                 sharing a prompt prefix map its leading FULL pages
                 instead of recomputing them (copy-on-write by
                 construction: nobody writes below its own frontier).

  quantized    — ``kv_quant_dtype="int8"|"fp8"``: pools in the storage
                 dtype plus per-layer fp32 scales ``[num_pages + 1, G,
                 heads]`` beside the page table; a freshly claimed page's
                 scales are reset to 0, and each append requantizes its
                 write window (``ops.kv_quant``).

The decode step runs the paged-decode kernel (K3, or K3-quant for
quantized pools) through ``ops.paged_attention.paged_decode_attention``.
Pools and scales are updated in place (``index_put_``) where the
reference donated them to XLA.

  megastep     — ``megastep_dispatch`` runs up to ``megastep_k`` decode
                 trips per host dispatch, the reference's ``lax.while_loop``
                 (``_megastep_impl``) as a CUDA graph: one trip over
                 static tensors (token feedback, write coordinates,
                 sampling, EOS/budget freezing, all on the device) is
                 captured once per variant (greedy, or with temperature
                 draws) and replayed ``k_eff`` times. A graph cannot stop
                 on device data: the replays after every slot froze do
                 masked work that writes only the scratch page, and
                 ``trips`` counts the trips that began with a slot live,
                 the reference's early-exit count. On the CPU the same
                 trip runs eagerly ``k_eff`` times.

  speculative  — ``verify_step`` scores a [max_slots, T] chunk (each
                 slot's pending input and the draft's proposals) in one
                 call through the plain ``paged_chunk_attention``, as the
                 reference computes it outside any Pallas kernel;
                 :func:`speculative_round` accepts the longest agreeing
                 prefix. Every plain decode step, the synced fallback of a
                 speculative run included, stays on K3 / K3-quant.
  preemption   — ``preempt_release`` parks a slot's full pages in the
                 prefix cache and frees the rest; work queued after a
                 megastep on the caller's stream runs after its trips.

Not ported yet: KV export/adopt and the fleet prefix tier. (A quantized
engine that adopts pages must refuse them without their scales, as the
reference's ``adopt_prefix`` does.)
"""

import contextlib
import hashlib
import time
import types
from collections import OrderedDict

import numpy as np
import torch

from .. import resolve_device
from ..observability import catalog, tracing
from ..ops import launch_count, paged_attention
from ..ops.kv_quant import KVQuantConfig
from .batcher import OverloadedError
from .generation import (_EngineBase, draw_tokens, params_to_device,
                         resolve_generation_knobs, sample_tokens)

__all__ = ["PagePool", "PagedDecodeEngine", "PoolExhaustedError",
           "PrefixCache", "chain_keys", "validate_draft_geometry",
           "can_speculate", "speculative_round",
           "speculative_greedy_generate"]


class PoolExhaustedError(OverloadedError):
    """The page pool cannot cover a request's worst-case budget even
    after evicting every sole-owner prefix-cache page (HTTP 503)."""


def chain_keys(prompt, page_size, n_blocks):
    """Content addresses of the prompt's leading token blocks: the
    running sha1 over ``block_0 .. block_i`` (position-0-anchored, so
    only identical prefixes share a key) — the reference's scheme."""
    h = hashlib.sha1()
    keys = []
    prompt = np.asarray(prompt, np.int32)
    for b in range(int(n_blocks)):
        h.update(prompt[b * page_size:(b + 1) * page_size].tobytes())
        keys.append(h.digest())
    return keys


class PagePool:
    """Host-side page allocator with refcounts: which pool rows are free
    and how many owners (slots and/or the prefix cache) each row has."""

    def __init__(self, num_pages):
        self.num_pages = int(num_pages)
        self._free = list(range(self.num_pages - 1, -1, -1))
        self.refs = np.zeros(self.num_pages, np.int32)

    def free_pages(self):
        return len(self._free)

    def alloc(self, n):
        """Claim ``n`` pages at refcount 1."""
        if n > len(self._free):
            raise PoolExhaustedError("page pool exhausted: need %d pages, "
                                     "%d free" % (n, len(self._free)))
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self.refs[p] = 1
        return out

    def incref(self, pids):
        for p in pids:
            self.refs[p] += 1

    def decref(self, pids):
        for p in pids:
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)

    def reset(self):
        self._free = list(range(self.num_pages - 1, -1, -1))
        self.refs[:] = 0


class PrefixCache:
    """Refcounted prompt-prefix page cache keyed by hashed block chains.
    Only FULL pages are cached; the cache holds one reference on each
    entry's page. ``capacity`` bounds the entry count LRU-style; under
    pool pressure :meth:`evict_for` drops sole-owner entries."""

    def __init__(self, pool, page_size, capacity=4096):
        self._pool = pool
        self._page = int(page_size)
        self._capacity = int(capacity)
        self._entries = OrderedDict()  # chain digest -> page id

    def __len__(self):
        return len(self._entries)

    def match(self, prompt, max_blocks):
        """Longest cached chain of the prompt's leading full blocks
        (≤ ``max_blocks``) → ``(keys, page_ids)``; refcounts untouched."""
        out_k, out_p = [], []
        for k in chain_keys(prompt, self._page, max_blocks):
            pid = self._entries.get(k)
            if pid is None:
                break
            out_k.append(k)
            out_p.append(pid)
        return out_k, out_p

    def acquire(self, keys, pids):
        """Take a slot reference on matched pages (+LRU touch)."""
        self._pool.incref(pids)
        for k in keys:
            self._entries.move_to_end(k)
        if pids:
            catalog.PREFIX_CACHE_HITS.inc(float(len(pids)))

    def insert(self, prompt, n, page_ids):
        """Register the prompt's full blocks (pages a slot owns, already
        prefilled); blocks already cached are skipped."""
        n_blocks = min(int(n) // self._page, len(page_ids))
        for key, pid in zip(chain_keys(prompt, self._page, n_blocks),
                            page_ids):
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            self._entries[key] = pid
            self._pool.incref([pid])
            while len(self._entries) > self._capacity:
                old, old_pid = next(iter(self._entries.items()))
                del self._entries[old]
                self._pool.decref([old_pid])
                catalog.PREFIX_CACHE_EVICTIONS.inc()

    def evictable(self, protect=()):
        """Pages reclaimable now: entries the cache alone owns, minus the
        ``protect``ed keys."""
        prot = set(protect)
        return sum(1 for k, p in self._entries.items()
                   if k not in prot and self._pool.refs[p] == 1)

    def evict_for(self, n_pages, protect=()):
        """Drop LRU sole-owner entries until ``n_pages`` pages returned to
        the pool (or no candidates remain); returns pages freed."""
        freed = 0
        prot = set(protect)
        t0 = time.perf_counter()
        for key in list(self._entries):
            if freed >= n_pages:
                break
            pid = self._entries[key]
            if key in prot or self._pool.refs[pid] != 1:
                continue
            del self._entries[key]
            self._pool.decref([pid])
            freed += 1
            catalog.PREFIX_CACHE_EVICTIONS.inc()
            catalog.PAGE_EVICTIONS.inc()
        if freed:
            tracing.span_from(t0, "kv.page_evict", pages=freed,
                              wanted=int(n_pages))
        return freed

    def reset(self):
        """Forget every entry WITHOUT touching refcounts (for use right
        after the owning pool itself was reset)."""
        self._entries.clear()


class PagedDecodeEngine(_EngineBase):
    """Slot-managed paged-KV decode engine over one model + params:

    - ``prefill(slot, prompt, max_new_tokens=...)`` reserves the
      request's worst case ``ceil((prompt + budget) / page_size)`` pages
      and maps any cached shared prefix instead of recomputing it;
    - ``decode_step(temperatures, seed, step)`` advances every active
      slot by one token (K/V appended in place, attention through K3);
    - ``megastep_dispatch`` / ``megastep_sync`` / ``megastep_decode`` —
      up to ``megastep_k`` such steps per dispatch, replayed from a
      captured CUDA graph on the card;
    - ``can_admit`` / ``admission_state`` / ``fits_ever`` — free-page
      admission accounting for the scheduler;
    - ``verify_step`` / ``commit_tokens`` with ``speculative_k`` — the
      speculative-decode verify chunk (:func:`speculative_round`);
    - ``preempt_release`` — preemption to the scheduler's held lane.

    ``speculative_k`` (default ``FLAGS_speculative_k``) is the verify
    chunk of a speculative round. ``kv_quant_dtype`` (``off|int8|fp8``,
    default ``FLAGS_kv_quant_dtype``) and ``kv_quant_group`` (tokens per scale
    group, 0 = the page) select quantized pages; ``num_pages=0`` then
    sizes the pool to twice the dense-equivalent budget. ``megastep_k``
    (default ``FLAGS_generation_megastep_k``; 0 = auto) bounds the trips
    of one megastep.

    ``device`` defaults to ``"cuda"`` and raises without a GPU; pass
    ``"cpu"`` to run on the CPU. NOT thread-safe: one thread owns it."""

    def __init__(self, model, params, *, max_slots=None, max_len=None,
                 prefill_buckets=None, page_size=None, num_pages=None,
                 speculative_k=None, kv_quant_dtype=None,
                 kv_quant_group=None, megastep_k=None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.params = params_to_device(params, self.device)
        (self.max_slots, self.max_len, self.prefill_buckets,
         self.page_size, self.num_pages, self.speculative_k,
         self.kv_quant_dtype, self.kv_quant_group,
         self.megastep_k) = resolve_generation_knobs(
            max_slots, max_len, prefill_buckets, page_size=page_size,
            num_pages=num_pages, speculative_k=speculative_k,
            kv_quant_dtype=kv_quant_dtype, kv_quant_group=kv_quant_group,
            megastep_k=megastep_k, paged=True)
        self.kv_quant = None if self.kv_quant_dtype == "off" else \
            KVQuantConfig(self.kv_quant_dtype, self.page_size,
                          self.kv_quant_group)
        self._pool_dtype = model.dtype if self.kv_quant is None else \
            self.kv_quant.storage_dtype
        self.max_prompt_len = self.prefill_buckets[-1]
        self.pages_per_slot = -(-self.max_len // self.page_size)
        self.scratch_page = self.num_pages  # the pool's extra last row
        self._pool_shape = (self.num_pages + 1, self.page_size,
                            model.n_heads, model.head_dim)
        S = self.max_slots
        # host arrays typed as the reference types them
        self.lengths = np.zeros(S, np.int64)
        self.active = np.zeros(S, bool)
        self._in_tokens = np.zeros(S, np.int32)
        self._reserved = np.zeros(S, np.int64)  # prompt + budget per slot
        self._slot_pages = [[] for _ in range(S)]
        self._page_table = np.full((S, self.pages_per_slot),
                                   self.scratch_page, np.int32)
        self.pool = PagePool(self.num_pages)
        self.prefix_cache = PrefixCache(self.pool, self.page_size)
        self.last_prefill_stats = {}
        # what the decode path ran: eager decode steps, megasteps, their
        # trips (replays of a captured trip on the card, eager trips on
        # the CPU), warm-up trips, captures by variant
        self.trip_stats = {"decode_steps": 0, "megasteps": 0,
                           "trips_dispatched": 0, "replays": 0,
                           "eager_trips": 0, "warmups": 0,
                           "captures_greedy": 0, "captures_sampling": 0}
        self._ms = None
        self.reset()

    def reset(self):
        """(Re)allocate zeroed pools and clear the allocator, the prefix
        cache and every slot's host bookkeeping — required after
        :class:`DeviceStateError`, harmless otherwise. Captured megastep
        graphs hold the old pools' addresses: they are dropped, after
        the device finished what was queued."""
        if self._ms is not None and self.device.type == "cuda":
            with contextlib.suppress(Exception):  # a faulted device
                torch.cuda.synchronize(self.device)
        self._ms = None

        def zeros(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=self.device)
                    for _ in range(self.model.n_layers)]
        self._kp = zeros(self._pool_shape, self._pool_dtype)
        self._vp = zeros(self._pool_shape, self._pool_dtype)
        self._ks = self._vs = None
        if self.kv_quant is not None:
            shape = self.kv_quant.scale_shape(self.num_pages + 1,
                                              self.model.n_heads)
            self._ks = zeros(shape, torch.float32)
            self._vs = zeros(shape, torch.float32)
        self.pool.reset()
        self.prefix_cache.reset()
        self.lengths[:] = 0
        self.active[:] = False
        self._in_tokens[:] = 0
        self._reserved[:] = 0
        self._slot_pages = [[] for _ in range(self.max_slots)]
        self._page_table[:] = self.scratch_page
        self._dead = False

    def _tensor(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _prefill_window(self, start, bucket):
        """Table entries the prefill attention can reach (positions <
        start + bucket), snapped up to a power of two as the reference
        does."""
        need = -(-(int(start) + int(bucket)) // self.page_size)
        w = 1
        while w < need:
            w *= 2
        return min(w, self.pages_per_slot)

    # -- page accounting ----------------------------------------------
    def _budget(self, n, max_new_tokens):
        cap = self.max_len - n
        return cap if max_new_tokens is None else min(int(max_new_tokens),
                                                      cap)

    def _pages_for(self, total_tokens):
        return -(-int(total_tokens) // self.page_size)

    def fits_ever(self, n_prompt, max_new_tokens=None):
        """Whether this request could EVER be admitted (empty pool) — the
        submit-time 400-vs-503 distinction."""
        n = int(n_prompt)
        return self._pages_for(n + self._budget(n, max_new_tokens)) \
            <= self.num_pages

    def admission_state(self):
        """Snapshot of the pool-wide admission inputs — free pages and
        the sole-owner (evictable) prefix-cache keys — for one scheduler
        iteration."""
        refs = self.pool.refs
        return {"free": self.pool.free_pages(),
                "sole": frozenset(
                    k for k, p in self.prefix_cache._entries.items()
                    if refs[p] == 1)}

    def can_admit(self, prompt, max_new_tokens=None, snapshot=None):
        """True when free pages plus evictable prefix-cache pages cover
        the request's worst case, crediting its cached prefix."""
        prompt = np.asarray(prompt).reshape(-1)
        n = prompt.size
        budget = self._budget(n, max_new_tokens)
        keys, pids = self.prefix_cache.match(prompt,
                                             (n - 1) // self.page_size)
        needed = self._pages_for(n + budget) - len(pids)
        if snapshot is not None:
            return needed <= snapshot["free"] + \
                len(snapshot["sole"] - set(keys))
        return needed <= self.pool.free_pages() + \
            self.prefix_cache.evictable(protect=keys)

    def pages_in_use(self):
        return self.num_pages - self.pool.free_pages()

    def page_stats(self):
        """Live pool occupancy for /metrics gauges.
        ``kv_pool_effective_capacity`` is the pool's admission token
        capacity (num_pages × page_size): at equal pool bytes a quantized
        pool's is ~2x the bf16 pool's."""
        return {"kv_pages_total": self.num_pages,
                "kv_pages_in_use": self.pages_in_use(),
                "prefix_cached_pages": len(self.prefix_cache),
                "kv_pool_effective_capacity":
                    self.num_pages * self.page_size,
                "kv_quant_dtype": self.kv_quant_dtype}

    # -- host surface -------------------------------------------------
    def free_slots(self):
        return [s for s in range(self.max_slots) if not self.active[s]]

    @torch.no_grad()
    def prefill(self, slot, prompt, max_new_tokens=None):
        """Prefill ``prompt`` into ``slot``, reserving pages for ``prompt +
        max_new_tokens`` (default: to ``max_len``). Leading full pages
        found in the prefix cache are MAPPED instead of recomputed; only
        the suffix runs, padded to its bucket. Returns the last
        position's logits (np.float32 [vocab]).

        Raises :class:`PoolExhaustedError` when the pool (after evicting
        sole-owner cached pages) cannot cover the reservation; validation
        errors raise ValueError before any allocation."""
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
        budget = self._budget(n, max_new_tokens)
        total = n + budget
        keys, hit_pids = self.prefix_cache.match(prompt,
                                                 (n - 1) // self.page_size)
        needed = self._pages_for(total) - len(hit_pids)
        short = needed - self.pool.free_pages()
        if short > 0:
            self.prefix_cache.evict_for(short, protect=keys)
        if needed > self.pool.free_pages():
            raise PoolExhaustedError(
                "kv page pool exhausted: request needs %d new pages "
                "(prompt %d + budget %d tokens at page_size %d, %d mapped "
                "from the prefix cache) but only %d are free — retry later"
                % (needed, n, budget, self.page_size, len(hit_pids),
                   self.pool.free_pages()))
        self.prefix_cache.acquire(keys, hit_pids)
        pids = hit_pids + self.pool.alloc(needed)
        row = np.full(self.pages_per_slot, self.scratch_page, np.int32)
        row[:len(pids)] = pids
        start = len(hit_pids) * self.page_size
        suffix = prompt[start:]
        m = suffix.size  # >= 1: match() is capped at (n-1)//page blocks
        bucket = next(b for b in self.prefill_buckets if b >= m)
        buf = np.zeros(bucket, np.int32)
        buf[:m] = suffix
        pos = start + np.arange(bucket)
        in_range = pos < start + m
        wpids = np.where(in_range, row[np.minimum(
            pos // self.page_size, self.pages_per_slot - 1)],
            self.scratch_page).astype(np.int64)
        woffs = np.where(in_range, pos % self.page_size, 0).astype(np.int64)
        window = self._prefill_window(start, bucket)
        quant = {}
        if self.kv_quant is not None:
            # the write WINDOW: the chunk starts page-aligned (start = full
            # shared pages), so its pages are the next ceil(bucket / page)
            # table entries, plus scratch for the padded tail
            p0 = start // self.page_size
            wr = -(-bucket // self.page_size)
            win = np.full(wr + 1, self.scratch_page, np.int64)
            lo = np.arange(wr) + p0
            ok = lo < self.pages_per_slot
            win[:wr][ok] = row[lo[ok]]
            w_idx = np.where(in_range, pos // self.page_size - p0, wr)
            quant = {"k_scales": self._ks, "v_scales": self._vs,
                     "kv_quant": self.kv_quant,
                     "win_pids": self._tensor(win),
                     "w_idx": self._tensor(w_idx.astype(np.int64))}
        try:
            with tracing.span("engine.prefill", slot=int(slot),
                              bucket=int(bucket), n_prompt=int(n),
                              prefix_hit_pages=len(hit_pids),
                              pages_reserved=int(needed), start=int(start)):
                if self.kv_quant is not None:
                    # freshly claimed pages start at scale 0: a previous
                    # occupant's scale only grows and would coarsen them
                    self._guarded(self._reset_scales, pids[len(hit_pids):])
                logits = self._guarded(
                    self.model.paged_prefill_logits, self.params,
                    self._tensor(buf), int(m), int(start),
                    self._tensor(wpids), self._tensor(woffs),
                    self._tensor(row[:window]), self._kp, self._vp,
                    **quant)
                logits = logits.float().cpu().numpy()
                if self.kv_quant is not None:
                    catalog.KV_QUANT_PAGES.inc(float(needed))
        except Exception:
            if not self._dead:  # failed before touching the pools
                self.pool.decref(pids)
            raise
        self._slot_pages[slot] = pids
        self._page_table[slot] = row
        self.lengths[slot] = n
        self._reserved[slot] = total
        self.active[slot] = True
        # future requests sharing this prompt's leading FULL pages map
        # them instead of re-prefilling; generated tokens are never cached
        self.prefix_cache.insert(prompt, n, pids)
        self.last_prefill_stats = {"prefix_hit_pages": len(hit_pids),
                                   "pages_reserved": int(needed)}
        return logits

    def set_input_token(self, slot, token):
        """The token the next decode step consumes for ``slot``."""
        self._in_tokens[slot] = np.int32(token)

    def _reset_scales(self, pids):
        """Zero the quant scales of freshly (re)claimed pages, in place."""
        if not len(pids):
            return
        idx = self._tensor(np.asarray(pids, np.int64))
        for sc in self._ks + self._vs:
            sc.index_fill_(0, idx, 0.0)

    def _step_write_coords(self, positions):
        """Per-slot (page id, offset) for writing at ``positions`` [S]:
        inactive slots and positions at/over the slot's reservation go to
        the scratch page at offset 0."""
        valid = self.active & (positions < self._reserved)
        pidx = np.where(valid, positions // self.page_size, 0)
        offs = np.where(valid, positions % self.page_size, 0)
        pids = np.where(
            valid,
            self._page_table[np.arange(self.max_slots),
                             np.minimum(pidx, self.pages_per_slot - 1)],
            self.scratch_page)
        return pids.astype(np.int64), offs.astype(np.int64)

    @torch.no_grad()
    def decode_step(self, temperatures=None, seed=0, step=0):
        """Advance every active slot by one token: greedy where the
        slot's temperature is <= 0, else drawn under ``(seed, step)``
        (:func:`~.generation.draw_tokens`). Returns the tokens (np.int32
        [max_slots]; inactive slots' entries are garbage)."""
        if not self.active.any():
            raise RuntimeError("decode_step with no active slots")
        if (self.lengths[self.active] >= self._reserved[self.active]).any():
            raise RuntimeError("an active slot is at its reserved page "
                               "budget — evict it first")
        self._check_live()
        temps = np.zeros(self.max_slots, np.float32) \
            if temperatures is None else np.asarray(temperatures, np.float32)
        wpids, woffs = self._step_write_coords(self.lengths)

        def run():
            logits = self.model.paged_decode_logits(
                self.params, self._tensor(self._in_tokens),
                self._tensor(self.lengths), self._tensor(self.active),
                self._tensor(wpids), self._tensor(woffs),
                self._tensor(self._page_table), self._kp, self._vp,
                k_scales=self._ks, v_scales=self._vs, kv_quant=self.kv_quant)
            return sample_tokens(logits, temps, seed, step).cpu().numpy()

        toks = self._guarded(run).astype(np.int32)
        self.trip_stats["decode_steps"] += 1
        self.lengths[self.active] += 1
        self._in_tokens = np.where(self.active, toks,
                                   self._in_tokens).astype(np.int32)
        return toks

    # -- megastep decoding -------------------------------------------
    def _ms_trip(self, sample):
        """One decode trip over the megastep's static tensors, in place:
        the counterpart of one ``_megastep_impl`` trip of the reference.
        Frozen slots (and positions at or over the reservation) write the
        scratch page; trip ``t`` draws under ``(seed, step0 + t)``."""
        m = self._ms
        v = m.v
        live = v.live.bool()
        pos = v.lengths
        valid = live & (pos < v.reserved)
        pidx = torch.clamp(pos // self.page_size,
                           max=self.pages_per_slot - 1)
        row = m.table.gather(1, pidx[:, None])[:, 0].long()
        wpids = torch.where(valid, row, self.scratch_page)
        woffs = torch.where(valid, pos % self.page_size, 0)
        logits = self.model.paged_decode_logits(
            self.params, v.tokens, pos, live, wpids, woffs, m.table,
            self._kp, self._vp, k_scales=self._ks, v_scales=self._vs,
            kv_quant=self.kv_quant)
        toks = torch.argmax(logits, dim=-1)
        if sample:
            toks = draw_tokens(logits, m.temps, v.seed, v.step0 + v.t, toks)
        toks = torch.where(live, toks, v.tokens)
        v.out.index_copy_(0, v.t, torch.where(live, toks, -1)[None])
        v.emitted += v.live
        v.lengths += v.live
        done = live & (((v.eos >= 0) & (toks == v.eos)) |
                       (v.emitted >= v.caps))
        v.trips += live.any()
        v.live.copy_(live & ~done)
        v.tokens.copy_(toks)
        v.t += 1

    def _ms_graph(self, sample):
        """The captured trip of one variant (greedy, or with temperature
        draws), made on first use on the megastep's side stream: a
        warm-up trip with every slot frozen (it writes only the scratch
        page and builds K3's plan and workspace and cuBLAS's state for
        this stream), then the capture of one trip on the same stream.
        Returns ``(graph, its capture's K3 calls (a
        ``launch_count.Capture``), K3's workspace)``; the workspace is
        kept alive with the graph, which holds its address."""
        m = self._ms
        if sample in m.graphs:
            return m.graphs[sample]
        m.v.live.zero_()
        m.v.t.zero_()
        self._ms_trip(sample)
        self.trip_stats["warmups"] += 1
        graph = torch.cuda.CUDAGraph()
        # thread_local: the CUDA calls of the server's other threads do
        # not invalidate this thread's capture
        with launch_count.Capture() as per, \
                torch.cuda.graph(graph, stream=m.stream,
                                 capture_error_mode="thread_local"):
            self._ms_trip(sample)
        ws = paged_attention._workspaces.get((self.device.index,
                                              m.stream.cuda_stream))
        m.graphs[sample] = (graph, per, ws)
        self.trip_stats["captures_sampling" if sample
                        else "captures_greedy"] += 1
        return m.graphs[sample]

    def _ms_load(self, m, args, temps):
        """Write one dispatch's arguments into the static tensors, in
        stream order (a megastep already queued still reads its own):
        the host values in one copy, then the device values of a chained
        dispatch over them; the temperatures and the page table."""
        host = np.zeros(m.state.numel(), np.int64)
        hv = _ms_views(host, self.megastep_k, self.max_slots)
        hv.out[:] = -1
        hv.reserved[:] = self._reserved
        on_device = {}
        for name, val in args.items():
            if torch.is_tensor(val):
                on_device[name] = val
            else:
                getattr(hv, name)[:] = val
        _stream_copy(m.state, host)
        for name, val in on_device.items():
            getattr(m.v, name).copy_(val.reshape(-1))
        _stream_copy(m.temps, temps)
        _stream_copy(m.table, self._page_table)

    @torch.no_grad()
    def _ms_run(self, k_eff, sample, args, temps):
        if self._ms is None:
            self._ms = _MegastepState(self)
        m = self._ms
        cuda = self.device.type == "cuda"
        if cuda:
            m.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(m.stream) if cuda else \
                contextlib.nullcontext():
            graph = self._ms_graph(sample) if cuda else None
            self._ms_load(m, args, temps)
            for _ in range(k_eff):
                if cuda:
                    graph[0].replay()
                else:
                    self._ms_trip(sample)
            snap = m.state.clone()
            done = None
            if cuda:
                host = torch.empty(snap.shape, dtype=snap.dtype,
                                   pin_memory=True)
                host.copy_(snap, non_blocking=True)
                done = torch.cuda.Event()
                done.record(m.stream)
            else:
                host = snap
        st = self.trip_stats
        st["megasteps"] += 1
        st["trips_dispatched"] += k_eff
        if cuda:
            # later work on the caller's stream (a prefill, a decode
            # step) runs after this megastep, as in the reference's one
            # device queue
            torch.cuda.current_stream(self.device).wait_stream(m.stream)
            graph[1].replayed(k_eff)
            st["replays"] += k_eff
        else:
            st["eager_trips"] += k_eff
        v = _ms_views(snap, self.megastep_k, self.max_slots)
        return {"out": v.out, "n_emitted": v.emitted, "lengths": v.lengths,
                "live": v.live, "tokens": v.tokens, "trips": v.trips,
                "caps": v.caps, "step0": v.step0, "k_eff": k_eff,
                "_host": host, "_done": done}

    def megastep_dispatch(self, seed, step0, k_eff, temperatures=None,
                          caps=None, eos_id=None, live=None, tokens=None,
                          lengths=None):
        """Queue one megastep — ``k_eff`` (in [1, megastep_k]) decode
        trips — and return a handle of device tensors without waiting for
        the device; host bookkeeping waits for :meth:`megastep_sync`.

        ``seed``/``step0`` pin the sampling stream: trip t draws as
        ``decode_step(seed=seed, step=step0 + t)`` does, so a megastep
        emits the step-at-a-time tokens. ``caps`` [max_slots] bounds the
        tokens each slot emits (default: its remaining reservation); a
        slot freezes on the device once it emits ``caps`` tokens or
        ``eos_id``.

        Chained dispatch: pass a previous handle's ``tokens``,
        ``lengths`` and ``live`` (and ``caps - n_emitted``, ``step0 +
        trips``, as device tensors) to queue megastep N+1 before syncing
        N; nothing is read back to the host. The temperatures, the
        reservations and the page table come from the host at every
        dispatch (a released slot's row is the scratch page)."""
        self._check_live()
        k_eff = int(k_eff)
        if not 1 <= k_eff <= self.megastep_k:
            raise ValueError(
                "k_eff=%d must be in [1, megastep_k=%d] (the captured trip "
                "writes a megastep_k-row token buffer)"
                % (k_eff, self.megastep_k))
        if tokens is None:
            live = self.active.copy() if live is None else \
                np.asarray(live, bool)
            if not live.any():
                raise RuntimeError("megastep_dispatch with no live slots")
            if (self.lengths[live] >= self._reserved[live]).any():
                raise RuntimeError(
                    "a live slot is at its reserved page budget — evict "
                    "it first")
            tokens, lengths = self._in_tokens, self.lengths
        if caps is None:
            caps = np.maximum(self._reserved - self.lengths, 0)
        temps = np.zeros(self.max_slots, np.float32) \
            if temperatures is None else np.asarray(temperatures,
                                                    np.float32)
        args = {"tokens": tokens, "lengths": lengths, "live": live,
                "caps": caps, "step0": step0, "seed": int(seed) & 0xFFFFFFFF,
                "eos": -1 if eos_id is None else int(eos_id)}
        return self._guarded(self._ms_run, k_eff, bool((temps > 0).any()),
                             args, temps)

    def megastep_sync(self, handle, only=None):
        """Wait for a dispatched megastep and apply its host bookkeeping.
        ``only`` (slot indices) limits which slots' lengths and pending
        tokens are applied: the caller passes the slots it still tracks,
        so a slot released (and perhaps re-admitted) while the megastep
        flew keeps its new state. Returns ``{"out": [trips, S] np.int32
        (-1 = frozen), "n_emitted": [S], "live": [S] bool, "trips":
        int}``."""
        def read(h):
            if h["_done"] is not None:
                h["_done"].synchronize()
            return h["_host"].numpy()
        v = _ms_views(self._guarded(read, handle), self.megastep_k,
                      self.max_slots)
        trips = int(v.trips[0])
        moved = v.emitted > 0
        if only is not None:
            mask = np.zeros(self.max_slots, bool)
            mask[[int(s) for s in only]] = True
            moved &= mask
        self.lengths[moved] = v.lengths[moved]
        self._in_tokens[moved] = v.tokens[moved]
        return {"out": v.out[:trips].astype(np.int32),
                "n_emitted": v.emitted.astype(np.int32),
                "live": v.live.astype(bool), "trips": trips}

    def megastep_decode(self, seed, step0, k_eff=None, temperatures=None,
                        caps=None, eos_id=None):
        """Dispatch and sync in one call (the scheduler uses the halves
        to keep one megastep in flight while it syncs the previous)."""
        return self.megastep_sync(self.megastep_dispatch(
            seed, step0, self.megastep_k if k_eff is None else k_eff,
            temperatures=temperatures, caps=caps, eos_id=eos_id))

    # -- speculative decoding -----------------------------------------
    def _verify_run(self, chunk, base, wpids, woffs, quant):
        logits = self.model.paged_verify_logits(
            self.params, self._tensor(chunk), self._tensor(base),
            self._tensor(self.active), self._tensor(wpids),
            self._tensor(woffs), self._tensor(self._page_table), self._kp,
            self._vp, k_scales=self._ks, v_scales=self._vs,
            kv_quant=self.kv_quant, **quant)
        return torch.argmax(logits, dim=-1).cpu().numpy()

    @torch.no_grad()
    def verify_step(self, chunk_tokens):
        """Score a ``[max_slots, T]`` chunk (each slot's pending input
        token followed by draft proposals) in one call, writing the
        chunk's K/V at positions ``lengths .. lengths + T - 1``
        (scratch-redirected past each slot's reservation) WITHOUT
        advancing ``lengths``: the caller commits the accepted prefix
        (:func:`speculative_round`). Returns np.int32 [max_slots, T]
        greedy next tokens; column j follows chunk token j."""
        chunk = np.asarray(chunk_tokens, np.int32)
        if chunk.ndim != 2 or chunk.shape[0] != self.max_slots:
            raise ValueError("chunk must be [max_slots, T]")
        if not self.active.any():
            raise RuntimeError("verify_step with no active slots")
        self._check_live()
        T = chunk.shape[1]
        page = self.page_size
        pos = self.lengths[:, None] + np.arange(T)[None, :]
        valid = self.active[:, None] & (pos < self._reserved[:, None])
        pidx = np.where(valid, pos // page, 0)
        woffs = np.where(valid, pos % page, 0).astype(np.int64)
        rows = np.take_along_axis(
            self._page_table, np.minimum(pidx, self.pages_per_slot - 1),
            axis=1)
        wpids = np.where(valid, rows, self.scratch_page).astype(np.int64)
        base = np.where(self.active, self.lengths, 0).astype(np.int64)
        quant = {}
        if self.kv_quant is not None:
            # the write window: T positions starting mid-page span at most
            # ceil((T + page - 2) / page) + 1 consecutive pages, plus one
            # scratch column for the redirected positions
            wr = (T + page - 2) // page + 1
            p0 = self.lengths // page                        # [S]
            span = p0[:, None] + np.arange(wr)[None, :]      # [S, wr]
            win = np.where(
                span < self.pages_per_slot,
                np.take_along_axis(self._page_table,
                                   np.minimum(span, self.pages_per_slot - 1),
                                   axis=1),
                self.scratch_page)
            win = np.concatenate(
                [win, np.full((self.max_slots, 1), self.scratch_page)],
                axis=1).astype(np.int64)
            w_idx = np.where(valid, pidx - p0[:, None], wr).astype(np.int64)
            quant = {"win_pids": self._tensor(win),
                     "w_idx": self._tensor(w_idx)}
        greedy = self._guarded(self._verify_run, chunk, base, wpids, woffs,
                               quant)
        return greedy.astype(np.int32)

    def commit_tokens(self, slot, n_tokens, next_input):
        """Advance a slot past ``n_tokens`` accepted chunk tokens and stage
        the next step's input — the accept half of a speculative round
        (rejected chunk positions keep garbage K/V in the slot's pages:
        masked now, overwritten when real tokens arrive)."""
        self.lengths[slot] += int(n_tokens)
        self._in_tokens[slot] = np.int32(next_input)

    def preempt_release(self, slot, seq):
        """Preemption to the scheduler's held lane: park the slot's
        computed K/V in the prefix cache, then release the slot. ``seq``
        is the token sequence whose K/V the slot holds — exactly
        ``lengths[slot]`` tokens (the prompt and every generated token but
        the pending input). Its leading FULL pages register in the cache
        (idempotent for pages that were prefix hits), so the re-admission
        prefill maps them and recomputes only the suffix; the partial
        tail page and the unused reservation return to the free list.
        Cached pages hold positions below the cached frontier, and every
        later write of any slot — a megastep still in flight for this one
        included — lands past it. The freed tail may still be written by a
        megastep in flight: each dispatch makes the caller's stream wait
        for its trips (``_ms_run``), so a prefill that reuses the pages
        runs after them. Returns the number of pages parked in the
        cache."""
        n = int(self.lengths[slot])
        pids = list(self._slot_pages[slot])
        cached = min(n // self.page_size, len(pids))
        self.prefix_cache.insert(np.asarray(seq, np.int32), n, pids)
        self.release(slot)
        return cached

    def release(self, slot):
        """Evict a finished sequence: drop the slot's page references
        (shared prefix pages survive in the cache; private pages return
        to the free list) and clear its host bookkeeping."""
        self.active[slot] = False
        self.pool.decref(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._page_table[slot] = self.scratch_page
        self.lengths[slot] = 0
        self._reserved[slot] = 0
        self._in_tokens[slot] = 0


def validate_draft_geometry(engine, draft_engine):
    """The draft must mirror the target's slot and length geometry: slot
    indices and cache positions are shared between the two engines."""
    if draft_engine.max_slots != engine.max_slots or \
            draft_engine.max_len != engine.max_len:
        raise ValueError(
            "draft engine geometry (max_slots=%d, max_len=%d) must match "
            "the target's (%d, %d)"
            % (draft_engine.max_slots, draft_engine.max_len,
               engine.max_slots, engine.max_len))


def can_speculate(engine, draft_engine, slots):
    """Whether a speculative round fits every slot in ``slots``: the
    k-token chunk must land inside both the target's page reservation and
    the draft's dense cache. The one predicate the scheduler and
    :func:`speculative_greedy_generate` share, so their streams agree."""
    k = int(engine.speculative_k)
    return all(
        int(engine.lengths[s]) + k <= int(engine._reserved[s]) and
        int(draft_engine.lengths[s]) + k <= draft_engine.max_len
        for s in slots)


def speculative_round(engine, draft_engine, live, budgets_left,
                      eos_id=None):
    """One speculative-decode round over every active slot: the draft
    proposes ``k = engine.speculative_k`` tokens (k greedy dense decode
    steps), the target scores the ``[pending input, d_1 .. d_{k-1}]``
    chunk in ONE verify step, and each slot accepts the longest prefix
    where the target's greedy choice agrees with the draft — emitting 1
    to k tokens, each what plain greedy decoding would emit (column j of
    the verify is the target's greedy choice after chunk token j, and the
    chunk's prefix is the accepted context by induction).

    ``live``: the slots being decoded; ``budgets_left``: {slot: tokens it
    may still emit}. Both engines' lengths and pending inputs are
    committed; the draft is REWOUND to the accepted prefix (its
    speculative rows stay until overwritten, masked by its lengths).
    Returns ``({slot: [emitted]}, {slot: accepted drafts})``, emissions
    truncated at EOS and budget; the accepted counts are exactly what
    ``speculative_accepted_tokens_total`` records.

    Caller contract: every active slot greedy, and :func:`can_speculate`
    true; otherwise the caller takes a synced plain step."""
    k = int(engine.speculative_k)
    len0 = engine.lengths.copy()
    in0 = engine._in_tokens.copy()
    drafted = np.zeros((engine.max_slots, k), np.int32)
    for j in range(k):
        drafted[:, j] = draft_engine.decode_step()
    chunk = np.concatenate([in0[:, None], drafted[:, :k - 1]], axis=1)
    greedy = engine.verify_step(chunk)
    catalog.SPECULATIVE_DRAFTED.inc(float(k * len(live)))
    out, accepted = {}, {}
    for s in live:
        g, d = greedy[s], drafted[s]
        a = 0
        while a < k and d[a] == g[a]:
            a += 1
        emitted = [int(t) for t in g[:min(a + 1, k)]]
        if eos_id is not None and eos_id in emitted:
            emitted = emitted[:emitted.index(eos_id) + 1]
        emitted = emitted[:max(int(budgets_left[s]), 1)]
        m = len(emitted)
        # emitted[j] confirms draft d_{j+1} for j < min(a, m): the drafts
        # that became output (acceptance rate = accepted / drafted)
        accepted[s] = min(a, m)
        catalog.SPECULATIVE_ACCEPTED.inc(float(accepted[s]))
        engine.commit_tokens(s, m, emitted[-1])
        draft_engine.lengths[s] = len0[s] + m   # rewind past the rejects
        draft_engine.set_input_token(s, emitted[-1])
        out[s] = emitted
    return out, accepted


def speculative_greedy_generate(engine, draft_engine, prompts,
                                max_new_tokens, *, eos_id=None):
    """Synchronous speculative greedy decode — the no-scheduler reference
    loop, token-identical to :func:`~.generation.greedy_generate` on
    the target engine alone. ``engine`` is a :class:`PagedDecodeEngine`
    with ``speculative_k >= 1``; ``draft_engine`` a dense engine over the
    draft model with the same slot and length geometry. When a round no
    longer fits (:func:`can_speculate`) every slot takes a synced plain
    step: the target decodes (K3) and the draft ingests the same input."""
    if engine.speculative_k < 1:
        raise ValueError("engine has speculative_k=0 — FLAGS_speculative_k "
                         "must be >= 1 for this path")
    validate_draft_geometry(engine, draft_engine)
    if engine.active.any() or draft_engine.active.any():
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
        draft_engine.prefill(i, prompt)
        budgets[i] = min(budgets[i], engine.max_len - int(engine.lengths[i]))
        tok = int(np.argmax(logits))
        outs[i].append(tok)
        if (eos_id is not None and tok == eos_id) or \
                len(outs[i]) >= budgets[i]:
            engine.release(i)
            draft_engine.release(i)
        else:
            engine.set_input_token(i, tok)
            draft_engine.set_input_token(i, tok)
            live[i] = True

    def finish(i):
        engine.release(i)
        draft_engine.release(i)
        del live[i]

    while live:
        if can_speculate(engine, draft_engine, live):
            left = {s: budgets[s] - len(outs[s]) for s in live}
            emitted, _ = speculative_round(engine, draft_engine, live, left,
                                           eos_id=eos_id)
            for s in list(live):
                outs[s].extend(emitted[s])
                if (eos_id is not None and outs[s][-1] == eos_id) or \
                        len(outs[s]) >= budgets[s]:
                    finish(s)
        else:
            toks = engine.decode_step()
            draft_engine.decode_step()
            for s in list(live):
                tok = int(toks[s])
                outs[s].append(tok)
                draft_engine.set_input_token(s, tok)
                if (eos_id is not None and tok == eos_id) or \
                        len(outs[s]) >= budgets[s] or \
                        engine.lengths[s] >= engine._reserved[s]:
                    finish(s)
    return outs


_MS_ROWS = ("tokens", "lengths", "live", "emitted", "caps", "reserved")
_MS_SCALARS = ("t", "trips", "step0", "eos", "seed")


def _ms_views(buf, K, S):
    """Named views of a megastep state vector (an int64 tensor or numpy
    array): ``out`` [K, S], the [S] rows, then the one-element scalars."""
    views = {"out": buf[:K * S].reshape(K, S)}
    at = K * S
    for name in _MS_ROWS:
        views[name] = buf[at:at + S]
        at += S
    for name in _MS_SCALARS:
        views[name] = buf[at:at + 1]
        at += 1
    return types.SimpleNamespace(**views)


def _stream_copy(dst, arr):
    """``dst.copy_(arr)`` for a host array; onto the card from pinned
    memory without blocking the host, so the copy takes its place in the
    current stream's order."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if dst.is_cuda:
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


class _MegastepState:
    """What a captured decode trip reads and writes: one int64 state
    vector (the [megastep_k, S] token buffer, each slot's pending token,
    length, live flag, emitted count, cap and reservation, and the trip
    index, trip count, step0, EOS id and seed), the temperatures and the
    page table; the side stream the trips run on, and the captured
    graphs by variant."""

    def __init__(self, engine):
        K, S, dev = engine.megastep_k, engine.max_slots, engine.device
        n = K * S + len(_MS_ROWS) * S + len(_MS_SCALARS)
        self.state = torch.zeros(n, dtype=torch.int64, device=dev)
        self.v = _ms_views(self.state, K, S)
        self.temps = torch.zeros(S, dtype=torch.float32, device=dev)
        self.table = torch.zeros(engine._page_table.shape,
                                 dtype=torch.int32, device=dev)
        self.stream = torch.cuda.Stream(device=dev) \
            if dev.type == "cuda" else None
        self.graphs = {}
