"""Deployment export: a pruned inference program as a self-contained
``torch.export`` artifact — the port of ``paddle_tpu/inference_export.py``
(``export_stablehlo`` / ``load_stablehlo`` / ``InferenceArtifact`` become
:func:`export_artifact` / :func:`load_artifact` /
:class:`InferenceArtifact`).

Unlike ``io.save_inference_model`` (the program's dict and its
persistables, run by this framework's executor), the artifact is one
``torch.export`` program (``__model__.pt2``): the parameters are its
buffers, the batch dimension is one symbolic ``torch.export.Dim``, and a
process runs it with ``torch`` and ``paddle_tpu_torch.ops`` (the
hand-written kernels' custom ops), without the model-building code.
``__export_meta__.json`` beside it names the feeds (dtype, shape with
``None`` for the batch dim, LoD level), the fetches and the static
``max_seq_len`` of ragged feeds.

On the card a loaded artifact runs each input shape as a CUDA graph: the
shape's first call runs eagerly and captures its graph, every later call
replays it (the counterpart of the reference's ``jax.jit`` around
``Exported.call``, which compiles each shape once). A kernel the graph
launches is counted at each replay (``ops.launch_count``).

Departures from the reference. The StableHLO artifact embeds its Mosaic
kernels; this one records each hand-written kernel as a ``paddle_tpu::``
custom op (``ops.flash_attention``: K1, K1-dense, K5-fwd, K6-fwd,
K6-fwd-dense), so loading it needs the port's op library. A program that
reaches any other hand-written kernel does not export: the kernel's
wrapper raises ``NotImplementedError`` naming it
(``ops.launch_count.refuse_export``). The artifact is traced on one
device and runs there. ``native_batch`` (the reference's PJRT runner
files) is not ported.
"""

import contextlib
import json
import os
import threading
import traceback

import numpy as np
import torch
import torch.utils._pytree as pytree

from .core import LoDArray, torch_dtype
from .executor import _fetch_from_env, global_scope, trace_ops
from .framework import Variable, default_main_program

__all__ = ["export_artifact", "load_artifact", "InferenceArtifact"]

_MODEL_FILE = "__model__.pt2"
_META_FILE = "__export_meta__.json"
# the batch the trace runs at (any size other than 0 and 1, which
# torch.export would take for constants), and the symbolic batch's range
_EXPORT_BATCH = 4
_MAX_BATCH = 4096


def _feed_meta(var, max_seq_len):
    """The meta record of one feed: dtype, shape with ``None`` for the
    batch dim (the leading -1), LoD level. int64 ids travel as int32, as
    the reference's with x64 off."""
    dtype = np.dtype(var.dtype or "float32")
    if dtype == np.int64:
        dtype = np.dtype(np.int32)
    shape = list(var.shape or [])
    polymorphic = bool(shape) and shape[0] == -1
    feat = shape[1:] if polymorphic else shape
    if any(d == -1 for d in feat):
        raise ValueError(
            "feed %r has non-leading unknown dims %s — only the batch "
            "dim may be polymorphic in an exported artifact"
            % (var.name, shape))
    if var.lod_level:
        if not polymorphic:
            raise ValueError("feed %r is a LoD sequence without a leading "
                             "-1 dim" % var.name)
        if max_seq_len is None:
            raise ValueError(
                "feed %r is a LoD sequence: export needs max_seq_len= "
                "(the artifact's sequence axis is static)" % var.name)
        # token-scalar int ids ([-1, 1] int decl) are stored (B, L)
        if feat == [1] and np.issubdtype(dtype, np.integer):
            feat = []
        shape = [None, int(max_seq_len)] + [int(d) for d in feat]
    else:
        shape = ([None] if polymorphic else []) + [int(d) for d in feat]
    return {"name": var.name, "lod": int(var.lod_level or 0),
            "dtype": dtype.name, "shape": shape}


def _example(spec, batch, device):
    """An example feed of ``spec`` at ``batch`` rows (zeros; full
    lengths)."""
    shape = [batch if d is None else d for d in spec["shape"]]
    data = torch.zeros(shape, dtype=getattr(torch, spec["dtype"]),
                       device=device)
    if spec["lod"]:
        return LoDArray(data, torch.full((batch,), shape[1],
                                         dtype=torch.int32, device=device))
    return data


class _InferenceModule(torch.nn.Module):
    """The pruned block as a module: the persistables are buffers, the
    feeds a dict of tensors (a ``LoDArray`` for a ragged feed), the
    fetches a tuple in fetch order."""

    def __init__(self, program, params, fetch_names, device):
        super().__init__()
        self._block = program.global_block()
        self._seed = program.random_seed or 0
        self._device = device
        self._fetch_names = list(fetch_names)
        self._params = {}
        for i, (name, t) in enumerate(sorted(params.items())):
            self.register_buffer("p%d" % i, t)
            self._params[name] = "p%d" % i

    def forward(self, feeds):
        env = {n: getattr(self, b) for n, b in self._params.items()}
        env.update(feeds)
        trace_ops(self._block, env, step_key=(self._seed, 0), is_test=True,
                  device=self._device, fetch_names=self._fetch_names)
        return tuple(_fetch_from_env(env, self._fetch_names))


class _NoTraceback:
    """Stands in for ``torch.utils._traceback.CapturedTraceback`` where
    ``torch.fx`` takes a node's stack trace: it captures nothing."""

    @staticmethod
    def extract(*args, **kwargs):
        return _NoTraceback()

    def summary(self):
        return traceback.StackSummary()


@contextlib.contextmanager
def _no_stack_traces():
    """No Python stack trace on each traced node: taking them is most of
    an export's time (ResNet-50's), and the artifact does not need them.
    Through ``torch.fx.config.do_not_emit_stack_traces`` where torch has
    it, else by capturing none where ``torch.fx`` takes them."""
    import torch.fx.config as fx_config
    import torch.fx.proxy as fx_proxy
    if hasattr(fx_config, "do_not_emit_stack_traces"):
        holder, name, value = fx_config, "do_not_emit_stack_traces", True
    else:
        holder, name, value = fx_proxy, "CapturedTraceback", _NoTraceback
    old = getattr(holder, name)
    setattr(holder, name, value)
    try:
        yield
    finally:
        setattr(holder, name, old)


def export_artifact(dirname, feeded_var_names, target_vars, executor,
                    main_program=None, scope=None, max_seq_len=None,
                    native_batch=None):
    """Prune ``main_program`` to the ops ``target_vars`` need, take the
    scope's persistables as the module's buffers, trace it with
    ``torch.export`` at 4 rows on the executor's device (the batch
    dimension symbolic, 1 to 4096) and write the
    artifact to ``dirname``. Returns the fetch names, as
    ``save_inference_model`` does. The reference's
    ``export_stablehlo``."""
    if native_batch is not None:
        raise NotImplementedError(
            "native_batch (the reference's PJRT runner files) is not "
            "ported: the port's artifact runs under torch")
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if isinstance(target_vars, Variable):
        target_vars = [target_vars]
    os.makedirs(dirname, exist_ok=True)

    pruned = main_program.prune(target_vars).inference_optimize()
    block = pruned.global_block()
    fetch_names = [v.name if isinstance(v, Variable) else v
                   for v in target_vars]
    device = executor.device
    params = {}
    for v in pruned.list_vars():
        val = scope.find_var(v.name) if v.persistable else None
        if val is not None:
            params[v.name] = torch.as_tensor(val).detach().to(device)
    feeds = [_feed_meta(block.var(n), max_seq_len) for n in feeded_var_names]
    module = _InferenceModule(pruned, params, fetch_names, device).eval()
    batch = torch.export.Dim("batch", min=1, max=_MAX_BATCH)
    examples, dyn = {}, {}
    for spec in feeds:
        examples[spec["name"]] = _example(spec, _EXPORT_BATCH, device)
        poly = {0: batch} if spec["shape"] and spec["shape"][0] is None \
            else None
        dyn[spec["name"]] = [poly, {0: batch}] if spec["lod"] else poly
    with torch.no_grad(), _no_stack_traces():
        ep = torch.export.export(module, (examples,), dynamic_shapes=(dyn,),
                                 strict=False)
    torch.export.save(ep, os.path.join(dirname, _MODEL_FILE))
    with open(os.path.join(dirname, _META_FILE), "w") as f:
        json.dump({"feeds": feeds, "fetch_var_names": fetch_names,
                   "max_seq_len": max_seq_len, "device": str(device),
                   "export_batch": _EXPORT_BATCH,
                   "format": "torch.export"}, f)
    return fetch_names


class _CapturedCall:
    """The module at one input shape as a CUDA graph over static input
    buffers: ``run`` copies the inputs in, replays, and returns copies of
    the outputs, all on the current stream (no host sync)."""

    def __init__(self, module, args, pool):
        from .ops import launch_count
        dev = pytree.tree_leaves(args)[0].device
        self.inputs = pytree.tree_map(torch.clone, args)
        self.recorded = launch_count.Capture()
        self.graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        # thread_local: the other threads' CUDA calls (a server's) do not
        # invalidate this thread's capture
        with self.recorded, torch.cuda.graph(
                self.graph, pool=pool, stream=side,
                capture_error_mode="thread_local"):
            self.outputs = module(self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)

    def run(self, args):
        for dst, src in zip(pytree.tree_leaves(self.inputs),
                            pytree.tree_leaves(args)):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        self.recorded.replayed(1)
        return pytree.tree_map(torch.clone, self.outputs)


class InferenceArtifact:
    """A loaded artifact: ``run(feed_dict)`` → list of numpy outputs in
    fetch order. No Program, Scope or model code involved.
    ``call(args)`` runs converted feeds and returns the device tensors
    without a host sync (the serving session's dispatch); on the card a
    shape's first call captures its CUDA graph, the later calls replay
    it."""

    def __init__(self, program, meta):
        self._program = program
        self._module = program.module()
        self.meta = meta
        self.feed_names = [f["name"] for f in meta["feeds"]]
        self.fetch_names = meta["fetch_var_names"]
        self.max_seq_len = meta.get("max_seq_len")
        self.device = torch.device(meta.get("device", "cpu"))
        self._graphs = {}         # input shapes -> _CapturedCall
        self._pool = None
        self._lock = threading.Lock()

    @property
    def graph(self):
        """The exported program's FX graph."""
        return self._program.graph

    def _convert(self, spec, value):
        """One feed as the artifact takes it (a tensor, or a ``LoDArray``
        of tensors, on its device), or a ``ValueError`` naming it."""
        name = spec["name"]
        dtype = np.dtype(spec["dtype"])
        if spec["lod"]:
            if isinstance(value, LoDArray):
                la = value
            else:
                try:
                    seqs = [np.asarray(s, dtype=dtype) for s in value]
                except (TypeError, ValueError) as e:
                    raise ValueError(
                        "feed %r: cannot convert ragged sequences to "
                        "dtype %s (%s)" % (name, dtype.name, e)) from e
                too_long = [len(s) for s in seqs
                            if len(s) > self.max_seq_len]
                if too_long:
                    raise ValueError(
                        "feed %r: sequence length %d exceeds the "
                        "artifact's exported max_seq_len=%d"
                        % (name, max(too_long), self.max_seq_len))
                la = LoDArray.from_sequences(seqs, dtype=dtype,
                                             max_len=self.max_seq_len)
            if tuple(la.data.shape)[1] != self.max_seq_len:
                raise ValueError(
                    "feed %r: padded sequence axis is %d but the artifact "
                    "was exported with static max_seq_len=%d"
                    % (name, tuple(la.data.shape)[1], self.max_seq_len))
            return LoDArray(self._tensor(la.data, dtype),
                            self._tensor(la.length, np.dtype(np.int32)))
        try:
            arr = value if isinstance(value, torch.Tensor) else \
                np.asarray(value, dtype=dtype)
        except (TypeError, ValueError) as e:
            raise ValueError("feed %r: cannot convert value to dtype %s "
                             "(%s)" % (name, dtype.name, e)) from e
        want = spec["shape"]
        shape = tuple(arr.shape)
        if len(want) == len(shape) + 1 and want[-1] == 1:
            arr = arr[..., None]
            shape = shape + (1,)
        if len(shape) != len(want):
            raise ValueError(
                "feed %r: got shape %s, artifact expects %d dims %s "
                "(None = polymorphic batch)"
                % (name, shape, len(want), want))
        for axis, (got, exp) in enumerate(zip(shape, want)):
            if exp is not None and got != exp:
                raise ValueError(
                    "feed %r: dim %d is %d, artifact expects %d "
                    "(full spec %s, got shape %s)"
                    % (name, axis, got, exp, want, shape))
        return self._tensor(arr, dtype)

    def _tensor(self, x, dtype):
        """``x`` as ``dtype`` on the artifact's device; a host array goes
        to a card from pinned memory, without blocking the host."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch_dtype(dtype.name))
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def convert(self, feed):
        """The feeds as the module takes them, checked by name."""
        args = {}
        for spec in self.meta["feeds"]:
            name = spec["name"]
            if name not in feed:
                raise KeyError("missing feed %r (expects %s)"
                               % (name, self.feed_names))
            args[name] = self._convert(spec, feed[name])
        return args

    def call(self, args):
        """The module on converted feeds: device tensors, no sync."""
        with torch.no_grad():
            if self.device.type != "cuda":
                return self._module(args)
            key = tuple((tuple(t.shape), t.dtype)
                        for t in pytree.tree_leaves(args))
            with self._lock:
                graph = self._graphs.get(key)
                if graph is not None:
                    return graph.run(args)
                # a shape's first call runs eagerly (and warms up what
                # the capture needs), then its graph is captured
                out = self._module(args)
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                self._graphs[key] = _CapturedCall(self._module, args,
                                                  self._pool)
                return out

    def run(self, feed):
        from .executor import _to_numpy
        return [_to_numpy(o) for o in self.call(self.convert(feed))]


def _validate_meta(dirname, meta):
    """Reject a malformed __export_meta__.json with an error naming the
    offending feed, before the program is loaded."""
    if not isinstance(meta, dict) or "feeds" not in meta or \
            "fetch_var_names" not in meta:
        raise ValueError(
            "%s: %s is not an export_artifact metadata file (needs "
            "'feeds' and 'fetch_var_names')" % (dirname, _META_FILE))
    for spec in meta["feeds"]:
        name = spec.get("name", "<unnamed>")
        missing = [k for k in ("name", "dtype", "shape", "lod")
                   if k not in spec]
        if missing:
            raise ValueError("%s: feed %r metadata is missing %s"
                             % (dirname, name, missing))
        try:
            np.dtype(spec["dtype"])
        except TypeError as e:
            raise ValueError("%s: feed %r has unknown dtype %r"
                             % (dirname, name, spec["dtype"])) from e
        shape = spec["shape"]
        if not isinstance(shape, list) or any(
                not (d is None or (isinstance(d, int) and d >= 0))
                for d in shape):
            raise ValueError(
                "%s: feed %r has malformed shape %r (want ints and at "
                "most one None batch dim)" % (dirname, name, shape))
        if sum(1 for d in shape if d is None) > 1:
            raise ValueError(
                "%s: feed %r has %d polymorphic dims in %r — only the "
                "batch dim may be polymorphic"
                % (dirname, name, sum(1 for d in shape if d is None),
                   shape))
        if spec["lod"] and not meta.get("max_seq_len"):
            raise ValueError(
                "%s: feed %r is a LoD sequence but the artifact records "
                "no max_seq_len" % (dirname, name))


def load_artifact(dirname):
    """An :class:`InferenceArtifact` from a directory that
    :func:`export_artifact` wrote (the reference's ``load_stablehlo``).
    Needs ``paddle_tpu_torch.ops`` (imported here) for the kernels'
    custom ops."""
    from . import ops  # noqa: F401  registers the paddle_tpu:: custom ops
    model_path = os.path.join(dirname, _MODEL_FILE)
    meta_path = os.path.join(dirname, _META_FILE)
    if not os.path.isdir(dirname):
        raise ValueError("%s is not a directory — expected a directory "
                         "written by export_artifact" % dirname)
    if not os.path.exists(model_path):
        have = sorted(os.listdir(dirname))
        raise ValueError(
            "%s is not an exported artifact: missing %s (directory "
            "contains: %s)" % (dirname, _MODEL_FILE,
                               ", ".join(have[:8]) or "<empty>"))
    if not os.path.exists(meta_path):
        raise ValueError("%s is not an exported artifact: missing %s"
                         % (dirname, _META_FILE))
    with open(meta_path) as f:
        try:
            meta = json.load(f)
        except ValueError as e:
            raise ValueError("%s: %s is not valid JSON (%s)"
                             % (dirname, _META_FILE, e)) from e
    _validate_meta(dirname, meta)
    try:
        # the example feeds the program keeps may hold LoDArrays
        with torch.serialization.safe_globals([LoDArray]):
            program = torch.export.load(model_path)
    except Exception as e:
        raise ValueError(
            "%s: %s exists but does not load as a torch.export program "
            "(%s: %s) — was it written by a compatible export_artifact?"
            % (dirname, _MODEL_FILE, type(e).__name__, e)) from e
    return InferenceArtifact(program, meta)
