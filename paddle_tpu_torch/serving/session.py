"""InferenceSession — the model half of ``/v1/infer``, the port of
``paddle_tpu/serving/session.py``.

Wraps either an exported artifact (``inference_export.load_artifact``)
or a pruned inference ``Program`` on an ``Executor`` behind one surface
the micro-batcher drives:

    assemble(requests) -> _BatchPlan     host: stack/pad a window
    dispatch(plan)     -> _BatchHandle   launch on the device, no sync
    collect(handle)    -> per-request outputs (the only host sync)

``dispatch`` copies the window to the device from pinned memory without
blocking (``InferenceArtifact.convert``), calls the model (on the card a
replay of the shape's captured graph) and records a CUDA event after it
(the ``FetchHandle``); ``collect`` waits on that event, so the batcher
thread assembles window N+1 while window N runs, as the reference's
``jax.jit`` dispatch lets it.

Shapes: ragged feeds pad onto the ``bucket_multiple`` grid
(``data.decorator.snap_length``; an artifact's sequence axis is its
static ``max_seq_len``), and the batch dim pads to the next power of two
when ``pad_batch_pow2`` is set (copies of row 0, dropped by
``collect``). The ``serving_compiled_shapes`` counter counts each
(length bucket, padded batch) the first time it is dispatched (an
artifact captures its graph then, as the reference compiles), so
``/metrics`` shows the shape churn.
"""

import threading
import time

import numpy as np

from .. import profiler
from ..core import LoDArray
from ..data.decorator import snap_length
from ..executor import Executor, FetchHandle, global_scope

__all__ = ["InferenceSession"]


class _BatchPlan:
    """An assembled window: the batched feed dict and what splitting the
    results back needs."""

    __slots__ = ("feed", "n_real", "padded_batch", "bucket_len")

    def __init__(self, feed, n_real, padded_batch, bucket_len):
        self.feed = feed
        self.n_real = n_real
        self.padded_batch = padded_batch
        self.bucket_len = bucket_len


class _BatchHandle:
    """One window in flight: its ``FetchHandle`` and plan."""

    __slots__ = ("fetch_handle", "plan")

    def __init__(self, fetch_handle, plan):
        self.fetch_handle = fetch_handle
        self.plan = plan


def _pow2_at_least(n):
    p = 1
    while p < n:
        p *= 2
    return p


class InferenceSession:
    """One servable model: :meth:`from_artifact` (an ``export_artifact``
    directory or a loaded ``InferenceArtifact``) or :meth:`from_program`
    (a pruned inference Program on an Executor). ``run_many(requests)``
    is assemble → dispatch → collect in one call."""

    def __init__(self, feed_specs, fetch_names, *, bucket_multiple=None,
                 pad_batch_pow2=True, max_seq_len=None):
        from .. import flags
        self.feed_specs = feed_specs            # [{name, lod, dtype, shape}]
        self.fetch_names = list(fetch_names)
        self.max_seq_len = max_seq_len
        self.bucket_multiple = (flags.bucket_multiple if bucket_multiple
                                is None else bucket_multiple)
        self.pad_batch_pow2 = bool(pad_batch_pow2)
        self._seen_shapes = set()  # guarded-by: _shapes_lock
        self._shapes_lock = threading.Lock()

    # -- constructors --------------------------------------------------
    @classmethod
    def from_artifact(cls, artifact, **kw):
        """``artifact``: an ``InferenceArtifact`` or a directory path."""
        from ..inference_export import InferenceArtifact, load_artifact
        if not isinstance(artifact, InferenceArtifact):
            artifact = load_artifact(artifact)
        self = cls(list(artifact.meta["feeds"]), artifact.fetch_names,
                   max_seq_len=artifact.max_seq_len, **kw)
        self._artifact = artifact
        self._backend = "artifact"
        return self

    @classmethod
    def from_program(cls, executor, program, feed_names, fetch_list,
                     scope=None, max_seq_len=None, **kw):
        """Serve a pruned inference program in-process (``program``: the
        inference slice, ``prune().inference_optimize()`` or a
        ``clone(for_test=True)``)."""
        block = program.global_block()
        specs = []
        for name in feed_names:
            var = block.var(name)
            shape = list(var.shape or [])
            if shape and shape[0] == -1:
                shape = [None] + [int(d) for d in shape[1:]]
            specs.append({"name": name, "lod": int(var.lod_level or 0),
                          "dtype": np.dtype(var.dtype or "float32").name,
                          "shape": shape})
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in fetch_list]
        self = cls(specs, fetch_names, max_seq_len=max_seq_len, **kw)
        self._executor = executor if executor is not None else Executor()
        self._program = program
        self._scope = scope if scope is not None else global_scope()
        self._backend = "program"
        return self

    # -- assembly ------------------------------------------------------
    def _bucketed_len(self, seqs):
        """Padded length of a window of ragged samples: the artifact's
        static length, else the window's longest snapped to the bucket
        grid (capped by ``max_seq_len`` when one was given)."""
        if self._backend == "artifact" and self.max_seq_len:
            return self.max_seq_len
        raw = max((len(s) for s in seqs), default=1)
        if self.max_seq_len and raw > self.max_seq_len:
            raise ValueError(
                "request sequence length %d exceeds session "
                "max_seq_len=%d" % (raw, self.max_seq_len))
        m = snap_length(raw, self.bucket_multiple)
        if self.max_seq_len:
            # a snap past an off-grid max_seq_len: every raw length fits
            m = min(m, self.max_seq_len)
        return m

    def assemble(self, requests):
        """Stack a window of per-request feed dicts (one sample each:
        dense samples shaped like the feature dims, ragged samples as a
        sequence) into one batched feed."""
        if not requests:
            raise ValueError("assemble() needs at least one request")
        n_real = len(requests)
        padded_batch = _pow2_at_least(n_real) if self.pad_batch_pow2 \
            else n_real
        feed = {}
        bucket_len = None
        for spec in self.feed_specs:
            name = spec["name"]
            vals = []
            for i, req in enumerate(requests):
                if name not in req:
                    raise KeyError(
                        "request %d is missing feed %r (expects %s)"
                        % (i, name, [s["name"] for s in self.feed_specs]))
                vals.append(req[name])
            dtype = np.dtype(spec["dtype"])
            if spec["lod"]:
                try:
                    seqs = [np.asarray(s, dtype=dtype) for s in vals]
                except (TypeError, ValueError) as e:
                    raise ValueError(
                        "feed %r: cannot convert request sequences to "
                        "dtype %s (%s)" % (name, dtype.name, e)) from e
                L = self._bucketed_len(seqs)
                too_long = [len(s) for s in seqs if len(s) > L]
                if too_long:
                    raise ValueError(
                        "feed %r: sequence length %d exceeds the padded "
                        "length %d" % (name, max(too_long), L))
                bucket_len = L if bucket_len is None else \
                    max(bucket_len, L)
                seqs = seqs + [seqs[0]] * (padded_batch - n_real)
                feed[name] = LoDArray.from_sequences(seqs, dtype=dtype,
                                                     max_len=L)
            else:
                feat = tuple(spec["shape"][1:]) \
                    if spec["shape"] and spec["shape"][0] is None \
                    else tuple(spec["shape"])
                rows = []
                for i, v in enumerate(vals):
                    try:
                        arr = np.asarray(v, dtype=dtype)
                    except (TypeError, ValueError) as e:
                        raise ValueError(
                            "feed %r (request %d): cannot convert to "
                            "dtype %s (%s)" % (name, i, dtype.name,
                                               e)) from e
                    if feat and arr.shape != feat:
                        # a trailing size-1 dim may be left off ([-1, 1]
                        # declarations), as the artifact allows
                        if arr.ndim + 1 == len(feat) and feat[-1] == 1:
                            arr = arr[..., None]
                        if arr.shape != feat:
                            raise ValueError(
                                "feed %r (request %d): sample shape %s "
                                "does not match the model's feature "
                                "shape %s" % (name, i, arr.shape, feat))
                    rows.append(arr)
                rows = rows + [rows[0]] * (padded_batch - n_real)
                feed[name] = np.stack(rows, axis=0)
        return _BatchPlan(feed, n_real, padded_batch, bucket_len)

    # -- dispatch / collect --------------------------------------------
    def dispatch(self, plan):
        """Launch the window on the device without waiting for it: the
        returned handle's ``FetchHandle`` holds a CUDA event recorded
        after the model's last kernel."""
        shape_key = (plan.bucket_len, plan.padded_batch)
        with self._shapes_lock:
            first_seen = shape_key not in self._seen_shapes
            if first_seen:
                self._seen_shapes.add(shape_key)
        if first_seen:
            profiler.incr_counter("serving_compiled_shapes")
        if self._backend == "artifact":
            # the artifact's conversion: errors naming the feed, pinned
            # non-blocking copies to the card
            outs = self._artifact.call(self._artifact.convert(plan.feed))
            fh = FetchHandle(self.fetch_names, list(outs))
        else:
            fh = self._executor.run(self._program, feed=plan.feed,
                                    fetch_list=self.fetch_names,
                                    scope=self._scope, return_numpy=False)
        return _BatchHandle(fh, plan)

    def collect(self, handle):
        """Wait for one window and split it into per-request output
        lists (padding rows and padded tokens dropped). The wait lands in
        the ``serving_device_wait_s`` counter."""
        t0 = time.perf_counter()
        outs = handle.fetch_handle.numpy()
        profiler.incr_counter("serving_device_wait_s",
                              time.perf_counter() - t0)
        n = handle.plan.n_real
        per_request = [[] for _ in range(n)]
        for out in outs:
            if isinstance(out, LoDArray):
                data = np.asarray(out.data)
                lens = np.asarray(out.length)
                for i in range(n):
                    per_request[i].append(data[i, : lens[i]])
            else:
                arr = np.asarray(out)
                for i in range(n):
                    # a batchless scalar output: every request sees it
                    per_request[i].append(arr if arr.ndim == 0 else arr[i])
        return per_request

    def run_many(self, requests):
        """assemble → dispatch → collect for one window."""
        return self.collect(self.dispatch(self.assemble(requests)))

    def run_one(self, request):
        """One request as a window of one."""
        return self.run_many([request])[0]

    @property
    def compiled_shapes(self):
        """Shape keys (bucket_len, padded_batch) dispatched so far."""
        with self._shapes_lock:
            return set(self._seen_shapes)
