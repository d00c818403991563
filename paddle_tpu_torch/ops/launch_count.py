"""Launch counts of the hand-written kernels, through CUDA-graph replays.

Each kernel wrapper calls :func:`launched` where it launches its kernel,
and nowhere else; ``add(name, n)`` is how the wrapper adds ``n`` to its
own count of kernel ``name``. A call made while the current stream is
being captured into a CUDA graph launches nothing then: it adds to
``recorded`` instead, and whoever captured the graph adds the calls its
capture recorded at each replay (:class:`Capture`). A host buffer that a
captured node reads at every replay (K4's pinned pointer table) is
handed to :func:`keep_alive`, and the capture keeps it, unchanged, as
long as the graph. :func:`refuse_export` is how a kernel without a
custom op refuses ``torch.export``.

A :class:`Capture` also holds Python's cyclic garbage collector off while
it is open. ``torch.cuda.graph`` (PyTorch 2.11) does not collect before it
begins, and a collection inside the capture runs the finalizers of
whatever dead cycles it finds, on the capturing thread: an executor that
was never closed frees its graphs, their memory pools, their pinned host
buffers and CUDA events there, and a CUDA call that such a release makes can
invalidate the capture (``cudaErrorStreamCaptureInvalidated`` at its
end). Held off, the cycles are collected after the capture.
"""

import gc
import threading

import torch

__all__ = ["launched", "keep_alive", "Capture", "recorded",
           "refuse_export"]

recorded = {}       # kernel name -> calls captured into CUDA graphs
_adders = {}        # kernel name -> how its wrapper adds launches
_kept = []          # host buffers read by the graphs being captured
# the collector's state while captures are open (any thread's)
_gc_hold = {"open": 0, "was_enabled": True}
_gc_lock = threading.Lock()


def launched(name, add):
    """Count one launch of kernel ``name``: ``add(name, 1)`` now, or,
    under capture, a recorded call that each replay adds."""
    if torch.cuda.is_current_stream_capturing():
        recorded[name] = recorded.get(name, 0) + 1
        _adders[name] = add
    else:
        add(name, 1)


def refuse_export(kernel):
    """Raise ``NotImplementedError`` naming ``kernel`` while
    ``torch.export`` traces: a kernel that is not a custom op cannot be
    recorded in an exported artifact (CPU tensors included, so a CPU
    export fails as a card's would)."""
    if torch.compiler.is_exporting():
        raise NotImplementedError(
            "kernel %s has no custom op: a program that reaches it cannot "
            "be exported (the exportable kernels are the flash forwards, "
            "paddle_tpu::flash_fwd and paddle_tpu::flash_fwd_segment)"
            % kernel)


def keep_alive(buf):
    """Keep ``buf`` as long as the graph being captured reads it."""
    if torch.cuda.is_current_stream_capturing():
        _kept.append(buf)


class Capture:
    """What one capture recorded: wrap the capture in ``with Capture()
    as rec``, keep ``rec`` with the graph, and call
    ``rec.replayed(n)`` after ``n`` replays. ``per_replay``: kernel name
    -> calls a replay launches; ``kept``: the host buffers the graph
    reads. The cyclic garbage collector is off while it is open (module
    docstring)."""

    def __init__(self):
        self.per_replay, self.kept = {}, []

    def __enter__(self):
        with _gc_lock:
            if _gc_hold["open"] == 0:
                _gc_hold["was_enabled"] = gc.isenabled()
                gc.disable()
            _gc_hold["open"] += 1
        self._before = dict(recorded)
        self._kept0 = len(_kept)
        return self

    def __exit__(self, *exc):
        self.per_replay = {n: c - self._before.get(n, 0)
                           for n, c in recorded.items()
                           if c != self._before.get(n, 0)}
        self.kept = _kept[self._kept0:]
        del _kept[self._kept0:]
        with _gc_lock:
            _gc_hold["open"] -= 1
            if _gc_hold["open"] == 0 and _gc_hold["was_enabled"]:
                gc.enable()
        return False

    def replayed(self, times=1):
        """Add the launches of ``times`` replays of the graph."""
        for name, n in self.per_replay.items():
            _adders[name](name, n * times)
