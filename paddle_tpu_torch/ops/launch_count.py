"""Launch counts of the hand-written kernels, through CUDA-graph replays.

Each kernel wrapper calls :func:`launched` where it launches its kernel,
and nowhere else; ``add(name, n)`` is how the wrapper adds ``n`` to its
own count of kernel ``name``. A call made while the current stream is
being captured into a CUDA graph launches nothing then: it adds to
``recorded`` instead, and whoever captured the graph adds the calls its
capture recorded at each replay (:class:`Capture`). A host buffer that a
captured node reads at every replay (K4's pinned pointer table) is
handed to :func:`keep_alive`, and the capture keeps it, unchanged, as
long as the graph.
"""

import torch

__all__ = ["launched", "keep_alive", "Capture", "recorded"]

recorded = {}       # kernel name -> calls captured into CUDA graphs
_adders = {}        # kernel name -> how its wrapper adds launches
_kept = []          # host buffers read by the graphs being captured


def launched(name, add):
    """Count one launch of kernel ``name``: ``add(name, 1)`` now, or,
    under capture, a recorded call that each replay adds."""
    if torch.cuda.is_current_stream_capturing():
        recorded[name] = recorded.get(name, 0) + 1
        _adders[name] = add
    else:
        add(name, 1)


def keep_alive(buf):
    """Keep ``buf`` as long as the graph being captured reads it."""
    if torch.cuda.is_current_stream_capturing():
        _kept.append(buf)


class Capture:
    """What one capture recorded: wrap the capture in ``with Capture()
    as rec``, keep ``rec`` with the graph, and call
    ``rec.replayed(n)`` after ``n`` replays. ``per_replay``: kernel name
    -> calls a replay launches; ``kept``: the host buffers the graph
    reads."""

    def __init__(self):
        self.per_replay, self.kept = {}, []

    def __enter__(self):
        self._before = dict(recorded)
        self._kept0 = len(_kept)
        return self

    def __exit__(self, *exc):
        self.per_replay = {n: c - self._before.get(n, 0)
                           for n, c in recorded.items()
                           if c != self._before.get(n, 0)}
        self.kept = _kept[self._kept0:]
        del _kept[self._kept0:]
        return False

    def replayed(self, times=1):
        """Add the launches of ``times`` replays of the graph."""
        for name, n in self.per_replay.items():
            _adders[name](name, n * times)
