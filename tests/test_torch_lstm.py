"""The ``lstm`` op (``layers.dynamic_lstm``) in the port against the JAX
package on the CPU, forward and through ``append_backward``: fp32 and
under ``enable_mixed_precision`` (an fc in bf16 before the recurrence,
which then runs in fp32 as JAX's promotion makes it), peepholes on and
off, ``is_reverse``, H0/C0 given and absent, Cell read and unread, and
other gate, cell and candidate activations. Each program runs one step
from the JAX startup program's state; lengths of 1 and of the full
window share a batch.

Tolerances: fp32 rel 1e-5 + abs 1e-6 (summation order). amp: each
output's and grad's relative L2 error within 1e-2 — both packages round
the fc's fp32 sums to bf16, but not always at the same ulp, and the
recurrence carries that difference through every step.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid

from tests.test_torch_lod import (PKG, JLoDArray, assert_close, ragged,
                                  run_both)

H = 4            # hidden width: the fc gives 4H gates
LENGTHS = (1, 6, 3, 6, 2)

VARIANTS = {
    "peep": dict(use_peepholes=True),
    "no-peep": dict(use_peepholes=False),
    "reverse": dict(is_reverse=True),
    "reverse-no-peep": dict(is_reverse=True, use_peepholes=False),
    "h0c0": dict(h0=True, c0=True),
    "h0-reverse": dict(h0=True, is_reverse=True),
    "cell-read": dict(cell=True),
    "cell-read-reverse-c0": dict(cell=True, is_reverse=True, c0=True),
    "acts": dict(gate_activation="tanh", cell_activation="relu",
                 candidate_activation="identity"),
    "acts-sigmoid-cell": dict(cell_activation="sigmoid",
                              candidate_activation="relu", h0=True),
}
AMP_VARIANTS = ("peep", "reverse", "h0c0", "cell-read")


def _net(v, amp):
    def build(fluid):
        _, _, append_backward = PKG["jax" if fluid is jfluid else "port"]
        x = fluid.layers.data(name="x", shape=[3], dtype="float32",
                              lod_level=1, stop_gradient=False)
        gates = fluid.layers.fc(input=x, size=4 * H, act="tanh")
        kw = {k: v[k] for k in ("use_peepholes", "is_reverse",
                                "gate_activation", "cell_activation",
                                "candidate_activation") if k in v}
        h0 = c0 = None
        if v.get("h0"):
            h0 = fluid.layers.data(name="h0", shape=[H], dtype="float32",
                                   stop_gradient=False)
        if v.get("c0"):
            c0 = fluid.layers.data(name="c0", shape=[H], dtype="float32",
                                   stop_gradient=False)
        hidden, cell = fluid.layers.dynamic_lstm(input=gates, size=4 * H,
                                                 h_0=h0, c_0=c0, **kw)
        loss = fluid.layers.mean(fluid.layers.sequence_pool(hidden, "sum"))
        fetch = [hidden, loss]
        if v.get("cell"):
            cl = fluid.layers.mean(fluid.layers.sequence_pool(cell, "max"))
            loss = fluid.layers.elementwise_add(loss, cl)
            fetch += [cell, loss]
        append_backward(loss)
        fluid.enable_mixed_precision(fluid.default_main_program(), amp)
        return fetch
    return build


def _run(name, amp):
    v = VARIANTS[name]
    rng = np.random.RandomState(7)
    feed = {"x": JLoDArray.from_sequences(ragged(rng, LENGTHS, (3,)))}
    names = ["x@GRAD", "lstm_0.w_0@GRAD", "lstm_0.b_0@GRAD",
             "fc_0.w_0@GRAD"]
    for k in ("h0", "c0"):
        if v.get(k):
            feed[k] = rng.randn(len(LENGTHS), H).astype(np.float32)
            names.append(k + "@GRAD")
    out, progs = run_both(_net(v, amp), feed, names)
    return out, progs, names


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_lstm_fp32_forward_and_grads(name):
    out, _, names = _run(name, amp=False)
    for n, a, b in zip(names + ["out%d" % i for i in range(4)],
                       out["port"][0], out["jax"][0]):
        assert_close(a, b, what=n)
    # the padding of Hidden (and Cell) is zero
    hidden = out["port"][0][len(names)]
    assert not hidden.data[0, 1:].any()


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", AMP_VARIANTS)
def test_lstm_amp_forward_and_grads(name):
    out, _, names = _run(name, amp=True)
    for n, a, b in zip(names + ["out%d" % i for i in range(4)],
                       out["port"][0], out["jax"][0]):
        if isinstance(b, JLoDArray):
            b, a = b.data, a.data
        assert np.shape(a) == np.shape(b), n
        assert _rel_l2(a, b) <= 1e-2, (n, _rel_l2(a, b))
