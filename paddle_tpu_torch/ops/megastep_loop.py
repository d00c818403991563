"""The megastep's trip loop: the wrapper of ``csrc/megastep_loop.cu`` and
its plain PyTorch version.

It replaces the reference's ``lax.while_loop`` in
``paddle_tpu/serving/paged_kv.py``'s ``_megastep_impl``: run one decode
trip while ``t < k_eff`` and a slot is live. The trip lives in an int64
state vector (the engine's ``_MegastepState``); :class:`Offsets` names
where its live row, trip index ``t``, ``k_eff`` and body-iteration
counter lie.

* On the card, :class:`WhileLoop` wraps the trip's captured CUDA graph in
  a graph of its own whose conditional WHILE node runs the trip, then a
  hand-written condition kernel that sets the node's handle to ``t < k_eff
  and any(live)`` and adds one to the iteration counter; one more
  condition kernel before the node decides the first trip. One megastep
  is one :meth:`WhileLoop.launch`: the trips stop on the device, with no
  host round trip and no masked trips after every slot froze.
* On the CPU, :func:`run_plain` is the same loop in Python: the only path
  for CPU tensors. A CUDA tensor never takes it.

``launches`` counts the loop graph's launches; the kernels inside a body
iteration (K3 / K3-quant) are known only once the iteration count is read
back, and the engine adds them then (``launch_count.Capture.replayed``).
"""

import collections
import ctypes

import torch

from . import launch_count

__all__ = ["Offsets", "WhileLoop", "run_plain", "condition_plain",
           "launches"]

launches = {"megastep_loop": 0}

# element offsets into the int64 state vector
Offsets = collections.namedtuple("Offsets", "S live t k_eff iters")


def _add(name, n):
    launches[name] += n


def condition_plain(state, off):
    """The condition kernel's predicate on a state vector: ``t < k_eff``
    and a slot live (a Python bool; reads the tensor)."""
    live = state[off.live:off.live + off.S]
    return bool(int(state[off.t]) < int(state[off.k_eff]) and
                bool((live != 0).any()))


def run_plain(trip, state, off):
    """The loop in plain PyTorch: ``trip()`` while :func:`condition_plain`
    holds, adding one to the iteration counter after each trip — the
    reference's ``lax.while_loop`` semantics exactly. Returns the number
    of trips run."""
    n = 0
    while condition_plain(state, off):
        trip()
        state[off.iters] += 1
        n += 1
    return n


def _bind():
    from .. import _build
    lib = _build.load("megastep_loop")
    if not getattr(lib, "_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.paddle_megastep_loop_build.argtypes = [ptr, ptr] + [i32] * 5 + \
            [ctypes.POINTER(ptr)]
        lib.paddle_megastep_loop_build.restype = i32
        lib.paddle_megastep_loop_launch.argtypes = [ptr, ptr]
        lib.paddle_megastep_loop_launch.restype = i32
        lib.paddle_megastep_loop_free.argtypes = [ptr]
        lib.paddle_megastep_loop_free.restype = None
        lib.paddle_megastep_loop_error_string.argtypes = [i32]
        lib.paddle_megastep_loop_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _raise(lib, what, err):
    raise RuntimeError("megastep loop %s failed: %s (CUDA error %d)"
                       % (what, lib.paddle_megastep_loop_error_string(
                           err).decode(), err))


class WhileLoop:
    """The loop graph around one captured trip. ``trip_graph`` is a
    ``torch.cuda.CUDAGraph`` made with ``keep_graph=True`` (its raw graph
    is copied into the loop's body; the caller keeps the torch graph, and
    with it the memory pool the trip's kernels use, as long as the loop);
    ``state`` is the int64 CUDA state vector the trip reads and writes."""

    def __init__(self, trip_graph, state, off):
        if state.device.type != "cuda" or state.dtype != torch.int64 or \
                not state.is_contiguous():
            raise ValueError("the megastep loop takes a contiguous int64 "
                             "CUDA state vector (got %s %s)"
                             % (state.dtype, state.device))
        self._lib = _bind()
        self._state = state
        out = ctypes.c_void_p()
        err = self._lib.paddle_megastep_loop_build(
            ctypes.c_void_p(trip_graph.raw_cuda_graph()),
            ctypes.c_void_p(state.data_ptr()), off.S, off.live, off.t,
            off.k_eff, off.iters, ctypes.byref(out))
        if err:
            _raise(self._lib, "build", err)
        self._loop = out.value

    def launch(self, stream):
        """One megastep: launch the loop graph on ``stream``."""
        launch_count.refuse_export("the megastep loop")
        err = self._lib.paddle_megastep_loop_launch(
            ctypes.c_void_p(self._loop), ctypes.c_void_p(stream.cuda_stream))
        if err:
            _raise(self._lib, "launch", err)
        launch_count.launched("megastep_loop", _add)

    def __del__(self):
        loop = getattr(self, "_loop", None)
        if loop:
            # the argtypes convert the int (no module globals: this may
            # run at interpreter exit)
            self._lib.paddle_megastep_loop_free(loop)
            self._loop = None
