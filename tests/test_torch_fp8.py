"""The port's fp8 storage recipe against the JAX package on the CPU.

``PADDLE_TPU_FP8_ACTS`` stores relu, gelu and layer-norm outputs as e4m3
under amp; ``PADDLE_TPU_FP8_CONV_OUT`` stores conv outputs as e4m3
(``1``/``e4m3``), e5m2, a per-tensor scaled ``ScaledFp8`` (``scaled``) or
one under the scale state of the last step (``delayed``). Consumers read
the stored values dequantized and no gradient is ever fp8.

- ``registry.cast_fp8``, the one store cast, bit for bit against
  ``astype`` in JAX on both formats, bf16 and fp32 sources, overflow
  included (e4m3fn gives NaN past 464 where ``Tensor.to`` saturates to
  448; e5m2 infinity from 61440).
- ``ScaledFp8.quantize`` / ``dequant`` bit for bit.
- Each fp8-aware lowering against the reference's, both called eagerly
  (under jit XLA may skip the bf16 rounding before the fp8 cast): conv2d
  under every mode, relu, layer_norm, pool2d, batch_norm,
  elementwise_add and mul bit for bit; gelu within one e4m3 ulp (the
  reference's eager bf16 gelu rounds each of its four ops to bf16,
  ``F.gelu`` rounds once, so 1.6% of the stored payloads differ by one
  e4m3 ulp). The conv cases feed dyadic inputs, whose fp32 sums are
  exact in any order, so the comparison holds the store and not the
  summation order (random inputs: within one fp8 ulp). The fp8-aware
  grads: bf16, against the reference's within the bf16 tolerance.
- The reference's program tests (``tests/ops/test_fp8_activations.py``)
  on its small conv net, run by both packages from one state: losses
  (fp8 against bf16 within rtol 0.15 / atol 0.05, as there; the port's
  against the reference's fp8 losses within rtol 0.02 — the reference
  keeps bf16 values unrounded inside XLA fusions, 0.4% apart at most
  over the first six steps on this net), no fp8 grad under any conv-out
  mode, the stored dtypes, the delayed scale state threaded in and out
  and within 1e-3 relative of the reference's after 8 steps, fp8
  fetches widened to fp32 and ``check_nan_inf`` over fp8.
"""

from tests import torch_threads  # noqa: F401  (first)
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique
from paddle_tpu.core import ScaledFp8 as JScaledFp8
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import global_scope as jglobal_scope
from paddle_tpu.executor import scope_guard as jscope_guard

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import executor as pexecutor
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch import unique_name as punique
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.core import ScaledFp8
from paddle_tpu_torch.registry import FP8_DTYPES, cast_fp8

from test_torch_train_ops import lower

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
JDT = {E4M3: jnp.float8_e4m3fn, E5M2: jnp.float8_e5m2}
BF16 = dict(atol=1e-2, rtol=1e-2)


def jbits(a):
    return np.asarray(a).view(np.uint8)


def pbits(t):
    return t.contiguous().view(torch.uint8).numpy()


def widen(v):
    """Any package's value as fp32 numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


def fp8_ulp(v, dtype):
    """One ulp of the fp8 ``dtype`` at each value of ``v`` (its
    subnormal spacing below the normal range)."""
    mant, emin = (3, -6) if dtype == E4M3 else (2, -14)
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** emin)))
    return 2.0 ** (e - mant)


# -- the cast ------------------------------------------------------------------

SWEEP = [0.0, 1.0, 448.0, 463.0, 464.0, 465.0, 466.0, 472.0, 478.0, 480.0,
         500.0, 872.0, 1e4, 57344.0, 57345.0, 61439.0, 61440.0, 61441.0,
         65536.0, 1e6, np.inf,
         2.0 ** -6, 2.0 ** -7, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11,
         2.0 ** -14, 2.0 ** -15, 2.0 ** -16, 2.0 ** -17, 1e-30]


@pytest.mark.parametrize("src", ["bfloat16", "float32"])
@pytest.mark.parametrize("dtype", [E4M3, E5M2], ids=["e4m3fn", "e5m2"])
def test_cast_fp8_is_the_reference_cast_bitwise(dtype, src):
    rng = np.random.RandomState(0)
    sweep = np.array(SWEEP, np.float32)
    xs = np.concatenate([sweep, -sweep, rng.randn(2000) * 100,
                         rng.randn(2000) * 3e4,
                         rng.randn(2000) * 1e-3]).astype(np.float32)
    want = jbits(jnp.asarray(xs).astype(getattr(jnp, src))
                 .astype(JDT[dtype]))
    got = pbits(cast_fp8(torch.from_numpy(xs).to(getattr(torch, src)),
                         dtype))
    bad = np.nonzero(got != want)[0]
    assert not len(bad), [(xs[i], hex(got[i]), hex(want[i]))
                          for i in bad[:8]]
    if dtype == E4M3:
        # where the plain cast saturates, the store gives NaN
        assert (torch.tensor([872.0]).to(E4M3).float() == 448.0).all()
        assert torch.isnan(cast_fp8(torch.tensor([872.0, -1e4]),
                                    E4M3).float()).all()
    nan = cast_fp8(torch.tensor([float("nan")]).to(getattr(torch, src)),
                   dtype)
    assert torch.isnan(nan.float()).all()


def test_scaled_fp8_quantize_and_dequant_match_the_reference():
    rng = np.random.RandomState(1)
    for x in ((rng.randn(6, 40) * 7).astype(np.float32),
              np.zeros((3, 5), np.float32)):
        for bf16 in (False, True):
            jx = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
            px = torch.from_numpy(x).to(torch.bfloat16 if bf16
                                        else torch.float32)
            j, p = JScaledFp8.quantize(jx), ScaledFp8.quantize(px)
            assert p.dtype == E4M3 and p.shape == x.shape
            np.testing.assert_array_equal(pbits(p.data), jbits(j.data))
            assert p.scale.dtype == torch.float32 and p.scale.dim() == 0
            np.testing.assert_array_equal(p.scale.numpy(),
                                          np.asarray(j.scale))
            for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                            (torch.float32, jnp.float32)):
                np.testing.assert_array_equal(widen(p.dequant(dt)),
                                              widen(j.dequant(jdt)))


# -- the lowerings --------------------------------------------------------------

def dyadic(rng, shape, lo, hi, den):
    return (rng.randint(lo, hi + 1, shape) / den).astype(np.float32)


CONV_ATTRS = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
              "groups": 1, "data_format": "NHWC"}
# (mode, Fp8Scale state or None, input scale): the delayed cases seed
# (0.0), shrink (a wide scale) and double (a scale that saturates)
CONV_MODES = [("1", None, 1), ("e4m3", None, 1), ("e5m2", None, 1),
              ("scaled", None, 1), ("delayed", 0.0, 1),
              ("delayed", 0.5, 1), ("delayed", 1e-3, 1),
              ("delayed", None, 1), ("1", None, 512), ("e5m2", None, 32768),
              ("scaled", None, 32768), ("delayed", 0.0, 32768)]


def _conv_case(rng, big, scale, dyadic_inputs=True):
    if dyadic_inputs:
        x = dyadic(rng, (2, 6, 6, 4), -8, 8, 4) * big
        w = dyadic(rng, (8, 4, 3, 3), -4, 4, 8)
    else:
        x = (rng.randn(2, 6, 6, 4) * big).astype(np.float32)
        w = (rng.randn(8, 4, 3, 3) * 0.3).astype(np.float32)
    ins = {"Input": [x], "Filter": [w]}
    if scale is not None:
        ins["Fp8Scale"] = [np.array([scale], np.float32)]
    return ins


def _both(op_type, ins, attrs, amp=True):
    """``op_type``'s lowering in each package on the same numpy inputs
    (values that are already a package's own pass through)."""
    def conv(v, pkg):
        if not isinstance(v, np.ndarray):
            return v[pkg]
        return jnp.asarray(v) if pkg == "jax" else torch.from_numpy(v)
    return (lower("jax", op_type, {s: [conv(v, "jax") for v in vs]
                                   for s, vs in ins.items()}, attrs, amp),
            lower("port", op_type, {s: [conv(v, "port") for v in vs]
                                    for s, vs in ins.items()}, attrs, amp))


def _payload(v):
    """(payload bits, scale or None) of a stored value of either
    package."""
    if isinstance(v, (ScaledFp8, JScaledFp8)):
        return _payload(v.data)[0], widen(v.scale)
    return (pbits(v) if isinstance(v, torch.Tensor) else jbits(v)), None


@pytest.mark.parametrize("mode,scale,big", CONV_MODES,
                         ids=["-".join(map(str, c)) for c in CONV_MODES])
def test_conv2d_output_store_bitwise(monkeypatch, mode, scale, big):
    monkeypatch.setenv("PADDLE_TPU_FP8_CONV_OUT", mode)
    rng = np.random.RandomState(2)
    jout, pout = _both("conv2d", _conv_case(rng, big, scale), CONV_ATTRS)
    j, p = jout["Output"][0], pout["Output"][0]
    scaled = mode == "scaled" or mode == "delayed"
    assert isinstance(p, ScaledFp8) == scaled == isinstance(j, JScaledFp8)
    want = {"1": E4M3, "e4m3": E4M3, "e5m2": E5M2}.get(mode, E4M3)
    assert p.dtype == want
    (pb, ps), (jb, js) = _payload(p), _payload(j)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(ps, js)
    if big > 1 and not scaled:
        # past the format's range: NaN (e4m3fn) or infinity (e5m2)
        assert (~np.isfinite(widen(p.data if scaled else p))).any()
    assert ("Fp8ScaleOut" in pout) == ("Fp8ScaleOut" in jout)
    if "Fp8ScaleOut" in jout:
        got, ref = pout["Fp8ScaleOut"][0], jout["Fp8ScaleOut"][0]
        assert got.dtype == torch.float32 and tuple(got.shape) == (1,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["1", "e5m2", "scaled", "delayed"])
def test_conv2d_output_store_random_inputs_within_one_ulp(monkeypatch,
                                                          mode):
    monkeypatch.setenv("PADDLE_TPU_FP8_CONV_OUT", mode)
    rng = np.random.RandomState(3)
    ins = _conv_case(rng, 3.0, 0.0 if mode == "delayed" else None,
                     dyadic_inputs=False)
    jout, pout = _both("conv2d", ins, CONV_ATTRS)
    j, p = jout["Output"][0], pout["Output"][0]
    dt = E5M2 if mode == "e5m2" else E4M3
    jq = widen(j.data if isinstance(j, JScaledFp8) else j)
    pq = widen(p.data if isinstance(p, ScaledFp8) else p)
    assert np.all(np.abs(pq - jq) <= fp8_ulp(jq, dt))
    assert np.mean(pq == jq) > 0.9


def test_conv2d_unknown_mode_raises_the_reference_error(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FP8_CONV_OUT", "e3m4")
    rng = np.random.RandomState(4)
    msgs = []
    for pkg in ("jax", "port"):
        ins = _conv_case(rng, 1, None)
        ins = {s: [jnp.asarray(v) if pkg == "jax" else torch.from_numpy(v)
                   for v in vs] for s, vs in ins.items()}
        with pytest.raises(ValueError) as e:
            lower(pkg, "conv2d", ins, CONV_ATTRS, True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "'e3m4'" in msgs[0]


def test_conv2d_stores_only_under_amp(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FP8_CONV_OUT", "e5m2")
    rng = np.random.RandomState(5)
    _, pout = _both("conv2d", _conv_case(rng, 1, None), CONV_ATTRS,
                    amp=False)
    assert pout["Output"][0].dtype == torch.float32


def _stored(rng, shape, dtype, scale=7.0, scaled=False):
    """A stored fp8 value in both packages (the same bits): raw, or a
    ``ScaledFp8`` of the reference's quantize."""
    x = jnp.asarray((rng.randn(*shape) * scale).astype(np.float32)) \
        .astype(jnp.bfloat16)
    if scaled:
        j = JScaledFp8.quantize(x)
        p = ScaledFp8(torch.from_numpy(jbits(j.data).copy()).view(E4M3),
                      torch.from_numpy(np.asarray(j.scale).copy()))
    else:
        j = x.astype(JDT[dtype])
        p = torch.from_numpy(jbits(j).copy()).view(dtype)
    return {"jax": j, "port": p}


def _assert_bitwise(jout, pout, slots):
    for s in slots:
        a, b = pout[s][0], jout[s][0]
        assert a.dtype == getattr(torch, str(b.dtype)), (s, a.dtype, b.dtype)
        if a.dtype in FP8_DTYPES:
            np.testing.assert_array_equal(pbits(a), jbits(b), err_msg=s)
        else:
            np.testing.assert_array_equal(widen(a), widen(b), err_msg=s)


def test_relu_and_layer_norm_store_e4m3_bitwise(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FP8_ACTS", "1")
    rng = np.random.RandomState(6)
    x = (rng.randn(8, 64) * 200).astype(np.float32)     # past 464 too
    xb = {"jax": jnp.asarray(x).astype(jnp.bfloat16),
          "port": torch.from_numpy(x).to(torch.bfloat16)}
    jout, pout = _both("relu", {"X": [xb]}, {})
    _assert_bitwise(jout, pout, ["Out"])
    assert pout["Out"][0].dtype == E4M3
    assert torch.isnan(pout["Out"][0].float()).any()
    ins = {"X": [xb], "Scale": [(1 + 0.1 * rng.randn(64)).astype(
        np.float32)], "Bias": [(0.1 * rng.randn(64)).astype(np.float32)]}
    jout, pout = _both("layer_norm", ins, {"begin_norm_axis": 1,
                                           "epsilon": 1e-5})
    _assert_bitwise(jout, pout, ["Y"])
    assert pout["Y"][0].dtype == E4M3
    # fp32 x: no store
    _, pout = _both("relu", {"X": [x]}, {})
    assert pout["Out"][0].dtype == torch.float32


def test_gelu_store_within_one_e4m3_ulp(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FP8_ACTS", "1")
    rng = np.random.RandomState(7)
    x = (rng.randn(16, 256) * 3).astype(np.float32)
    xb = {"jax": jnp.asarray(x).astype(jnp.bfloat16),
          "port": torch.from_numpy(x).to(torch.bfloat16)}
    jout, pout = _both("gelu", {"X": [xb]}, {"approximate": False})
    p, j = pout["Out"][0], jout["Out"][0]
    assert p.dtype == E4M3
    pq, jq = widen(p), widen(j)
    assert np.all(np.abs(pq - jq) <= fp8_ulp(jq, E4M3))
    assert np.mean(pq == jq) > 0.95


@pytest.mark.parametrize("dtype", [E4M3, E5M2], ids=["e4m3fn", "e5m2"])
def test_relu_on_raw_fp8_keeps_its_format_bitwise(monkeypatch, dtype):
    """relu of a stored fp8 value (a conv output the relu reads
    directly): Out in X's own format, every byte as the reference's
    ``jax.nn.relu`` gives it, infinities and values past 464 included,
    and no e4m3 store on top of an e5m2 X. A NaN (e4m3fn past 464) stays
    NaN; its sign bit is compared only where the reference's is
    determined (XLA's CPU code keeps a NaN's sign in some array lengths
    and clears it in others)."""
    monkeypatch.setenv("PADDLE_TPU_FP8_ACTS", "1")
    rng = np.random.RandomState(8)
    every = np.arange(256, dtype=np.uint8)
    big = jbits(jnp.asarray((rng.randn(512) * 600).astype(np.float32))
                .astype(jnp.bfloat16).astype(JDT[dtype]))
    b = np.concatenate([every, big])
    x = {"jax": jnp.asarray(b.view(JDT[dtype])),
         "port": torch.from_numpy(b.copy()).view(dtype)}
    jout, pout = _both("relu", {"X": [x]}, {})
    p, j = pout["Out"][0], jout["Out"][0]
    assert p.dtype == dtype == getattr(torch, str(j.dtype))
    nan = np.isnan(widen(j))
    np.testing.assert_array_equal(pbits(p)[~nan], jbits(j)[~nan])
    assert np.isnan(widen(p)[nan]).all() and nan.sum() >= 2
    # a NaN keeps its byte, as a number keeps its value
    np.testing.assert_array_equal(pbits(p)[nan], b[nan])


@pytest.mark.parametrize("dtype", [E4M3, E5M2], ids=["e4m3fn", "e5m2"])
def test_gelu_on_raw_fp8_keeps_its_format(monkeypatch, dtype):
    """gelu of a stored fp8 value: Out in X's own format, as the
    reference's tanh form gives it (its exact erf form does not lower for
    fp8 on the CPU). The reference computes in that format op by op, the
    port from the bf16 dequant: the port's values are held within one ulp
    of the reference's gelu of the dequant in fp32, stored in X's
    format."""
    monkeypatch.setenv("PADDLE_TPU_FP8_ACTS", "1")
    rng = np.random.RandomState(9)
    xq = jnp.asarray((rng.randn(16, 64) * 3).astype(np.float32)) \
        .astype(JDT[dtype])
    x = {"jax": xq, "port": torch.from_numpy(jbits(xq).copy()).view(dtype)}
    jout, pout = _both("gelu", {"X": [x]}, {"approximate": True})
    p = pout["Out"][0]
    assert p.dtype == dtype == getattr(torch, str(jout["Out"][0].dtype))
    want = widen(jax.nn.gelu(xq.astype(jnp.float32), approximate=True)
                 .astype(JDT[dtype]))
    got = widen(p)
    assert np.all(np.abs(got - want) <= fp8_ulp(want, dtype))
    assert np.mean(got == want) > 0.95


POOLS = {"max-3x3-s2-p1": {"pooling_type": "max", "ksize": [3, 3],
                           "strides": [2, 2], "paddings": [1, 1],
                           "data_format": "NHWC"},
         "avg-global": {"pooling_type": "avg", "ksize": [1, 1],
                        "global_pooling": True, "data_format": "NHWC"}}


def bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def _dequant_np(x):
    """What the consumers read: the bf16 dequant, as float64."""
    v = x["port"]
    return widen(v.dequant() if isinstance(v, ScaledFp8)
                 else v).astype(np.float64)


@pytest.mark.parametrize("stored", ["e4m3", "e5m2", "scaled"])
@pytest.mark.parametrize("pool", list(POOLS))
def test_pool2d_reads_fp8_bitwise(stored, pool):
    """Max pooling bit for bit. Average pooling: the port's is the exact
    mean rounded once to bf16 (within one bf16 ulp), the reference's
    within 8 bf16 ulps of the largest output — its bf16
    ``reduce_window`` rounds every partial sum (measured: 3-6 ulps)."""
    rng = np.random.RandomState(8)
    x = _stored(rng, (2, 8, 8, 16), E5M2 if stored == "e5m2" else E4M3,
                scaled=stored == "scaled")
    jout, pout = _both("pool2d", {"X": [x]}, POOLS[pool])
    assert pout["Out"][0].dtype == torch.bfloat16
    if pool.startswith("max"):
        _assert_bitwise(jout, pout, ["Out"])
        return
    got, ref = widen(pout["Out"][0]), widen(jout["Out"][0])
    exact = _dequant_np(x).mean(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(got - exact) <= bf16_ulp(exact))
    assert np.max(np.abs(got - ref)) <= 8 * bf16_ulp(np.abs(ref).max())


@pytest.mark.parametrize("stored", ["e4m3", "e5m2", "scaled"])
def test_batch_norm_reads_fp8(stored):
    rng = np.random.RandomState(9)
    c = 16
    x = _stored(rng, (4, 6, 6, c), E5M2 if stored == "e5m2" else E4M3,
                scale=5.0, scaled=stored == "scaled")
    ins = {"X": [x], "Scale": [(1 + 0.1 * rng.randn(c)).astype(np.float32)],
           "Bias": [(0.1 * rng.randn(c)).astype(np.float32)],
           "Mean": [(0.5 * rng.randn(c)).astype(np.float32)],
           "Variance": [(1 + 0.2 * np.abs(rng.randn(c))).astype(np.float32)]}
    attrs = {"epsilon": 1e-5, "momentum": 0.9, "data_layout": "NHWC"}
    jout, pout = _both("batch_norm", ins, attrs)
    assert pout["Y"][0].dtype == torch.bfloat16
    # the fp32 statistics are sums in another order: the per-channel
    # coefficients may differ in their last bit, which moves a few bf16
    # outputs by one ulp (measured: 2 of 2304)
    got, ref = widen(pout["Y"][0]), widen(jout["Y"][0])
    assert np.all(np.abs(got - ref) <= bf16_ulp(ref))
    assert np.mean(got == ref) >= 0.99
    for s in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        np.testing.assert_allclose(widen(pout[s][0]), widen(jout[s][0]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["fp8+fp8", "fp8+bias", "bf16+fp8",
                                  "scaled+fp8"])
def test_elementwise_add_computes_fp8_in_bf16_bitwise(case):
    rng = np.random.RandomState(10)
    a = _stored(rng, (2, 4, 4, 8), E4M3, scaled=case.startswith("scaled"))
    b = _stored(rng, (2, 4, 4, 8), E5M2)
    attrs = {"axis": -1}
    if case == "fp8+bias":
        b = (rng.randn(8) * 0.5).astype(np.float32)
        attrs = {"axis": 3}
    if case == "bf16+fp8":
        a = {"jax": jnp.asarray(rng.randn(2, 4, 4, 8).astype(np.float32))
             .astype(jnp.bfloat16),
             "port": None}
        a["port"] = torch.from_numpy(widen(a["jax"])).to(torch.bfloat16)
    jout, pout = _both("elementwise_add", {"X": [a], "Y": [b]}, attrs)
    _assert_bitwise(jout, pout, ["Out"])
    assert pout["Out"][0].dtype == torch.bfloat16


def test_mul_reads_fp8_bitwise():
    rng = np.random.RandomState(11)
    x = _stored(rng, (8, 16), E4M3, scale=1.5)
    w = dyadic(rng, (16, 8), -8, 8, 16)
    jout, pout = _both("mul", {"X": [x], "Y": [w]},
                       {"x_num_col_dims": 1, "y_num_col_dims": 1})
    _assert_bitwise(jout, pout, ["Out"])


# the fp8-aware grads: (op, forward inputs maker, attrs, wanted grads)
def _grad_cases(rng):
    c = 8
    bn = {"Scale": [(1 + 0.1 * rng.randn(c)).astype(np.float32)],
          "Bias": [(0.1 * rng.randn(c)).astype(np.float32)],
          "Mean": [np.zeros(c, np.float32)],
          "Variance": [np.ones(c, np.float32)]}
    return {
        "batch_norm": ({"X": [_stored(rng, (4, 4, 4, c), E5M2)], **bn},
                       {"epsilon": 1e-5, "momentum": 0.9,
                        "data_layout": "NHWC"}, ("X", "Scale", "Bias")),
        "batch_norm-scaled": ({"X": [_stored(rng, (4, 4, 4, c), E4M3,
                                             scaled=True)], **bn},
                              {"epsilon": 1e-5, "momentum": 0.9,
                               "data_layout": "NHWC"}, ("X",)),
        "pool2d": ({"X": [_stored(rng, (2, 8, 8, c), E4M3)]},
                   POOLS["max-3x3-s2-p1"], ("X",)),
        "elementwise_add": ({"X": [_stored(rng, (2, 4, 4, c), E4M3)],
                             "Y": [_stored(rng, (2, 4, 4, c), E5M2)]},
                            {"axis": -1}, ("X", "Y")),
        "mul": ({"X": [_stored(rng, (8, 16), E4M3, scale=1.0)],
                 "Y": [(rng.randn(16, c) * 0.3).astype(np.float32)]},
                {"x_num_col_dims": 1, "y_num_col_dims": 1}, ("X", "Y")),
        "gelu": ({"X": [{"jax": jnp.asarray(rng.randn(4, 32)
                                            .astype(np.float32))
                         .astype(jnp.bfloat16), "port": None}]},
                 {"approximate": False}, ("X",)),
        "layer_norm": ({"X": [{"jax": jnp.asarray(rng.randn(4, 32)
                                                  .astype(np.float32))
                               .astype(jnp.bfloat16), "port": None}],
                        "Scale": [np.ones(32, np.float32)],
                        "Bias": [np.zeros(32, np.float32)]},
                       {"begin_norm_axis": 1, "epsilon": 1e-5}, ("X",)),
        "conv2d": ({"Input": [_stored(rng, (2, 6, 6, 4), E4M3)],
                    "Filter": [(rng.randn(8, 4, 3, 3) * 0.3)
                               .astype(np.float32)]},
                   CONV_ATTRS, ("Input", "Filter")),
    }


@pytest.mark.parametrize("name", ["batch_norm", "batch_norm-scaled",
                                  "pool2d", "elementwise_add", "mul", "gelu",
                                  "layer_norm", "conv2d"])
def test_fp8_aware_grads_are_bf16_and_match_the_reference(monkeypatch,
                                                          name):
    """Every fp8-aware op's grad under the stores: the grads of stored
    inputs are bf16 (never fp8), the other inputs' keep their dtype, all
    within the bf16 tolerance of the reference's."""
    monkeypatch.setenv("PADDLE_TPU_FP8_ACTS", "1")
    monkeypatch.setenv("PADDLE_TPU_FP8_CONV_OUT", "e5m2")
    rng = np.random.RandomState(12)
    ins, attrs, grads = _grad_cases(rng)[name]
    for vs in ins.values():
        for v in vs:
            if isinstance(v, dict) and v["port"] is None:
                v["port"] = torch.from_numpy(widen(v["jax"])) \
                    .to(torch.bfloat16)
    op = name.split("-")[0]
    jout, pout = _both(op, ins, attrs)
    # the grad op's inputs: the forward's, its outputs, and a cotangent
    # for each output — bf16 for a bf16 or stored (fp8) one, as its
    # consumer's grad is, else fp32
    gattrs = dict(attrs, __fwd_input_slots__=list(ins),
                  __fwd_output_slots__=list(jout), __fwd_op_uid__=3)
    outputs = {s + "@GRAD": [s + "@GRAD"] for s in grads}
    jg, pg = {}, {}
    for s, vs in ins.items():
        jg[s] = [v["jax"] if isinstance(v, dict) else jnp.asarray(v)
                 for v in vs]
        pg[s] = [v["port"] if isinstance(v, dict) else torch.from_numpy(v)
                 for v in vs]
    for s in jout:
        jg[s], pg[s] = list(jout[s]), list(pout[s])
        y = jout[s][0]
        bf16 = isinstance(y, JScaledFp8) or "float8" in str(y.dtype) or \
            y.dtype == jnp.bfloat16
        g = rng.randn(*np.shape(y)).astype(np.float32)
        jg[s + "@GRAD"] = [jnp.asarray(g).astype(
            jnp.bfloat16 if bf16 else jnp.float32)]
        pg[s + "@GRAD"] = [torch.from_numpy(g).to(
            torch.bfloat16 if bf16 else torch.float32)]
    jgrad = lower("jax", op + "_grad", jg, gattrs, True, outputs)
    pgrad = lower("port", op + "_grad", pg, gattrs, True, outputs)
    for s in outputs:
        a, b = pgrad[s][0], jgrad[s][0]
        a = a.data if hasattr(a, "length") else a
        assert a.dtype not in FP8_DTYPES, (s, a.dtype)
        assert a.dtype == getattr(torch, str(b.dtype)), (s, a.dtype, b.dtype)
        np.testing.assert_allclose(widen(a), widen(b), err_msg=s, **BF16)


def test_relu_grad_widens_an_fp8_incoming_grad():
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(4, 8).astype(np.float32)) \
        .to(torch.bfloat16)
    g = cast_fp8(torch.from_numpy(rng.randn(4, 8).astype(np.float32)), E4M3)
    out = lower("port", "relu_grad", {"X": [x], "Out@GRAD": [g]}, {}, True,
                {"X@GRAD": ["x@GRAD"]})["X@GRAD"][0]
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(widen(out),
                                  np.where(widen(x) > 0, widen(g), 0.0))


def test_generic_grad_refuses_fp8_by_name():
    """An op without a transparent grad, given a stored fp8 input to
    differentiate, raises naming it — it never hands back an fp8
    grad."""
    from paddle_tpu_torch import registry as preg
    fn = preg.make_generic_grad_lowering("softmax")
    x = cast_fp8(torch.randn(2, 4), E4M3)
    op = type("Op", (), {"type": "softmax_grad", "op_uid": 1,
                         "attrs": {"__fwd_input_slots__": ["X"],
                                   "__fwd_output_slots__": ["Out"]},
                         "inputs": {}, "outputs": {"X@GRAD": ["g"]},
                         "forward_op": None})()
    ctx = preg.LoweringContext(op, step_key=(0, 0))
    with pytest.raises(TypeError, match="softmax_grad.*fp8"):
        fn(ctx, {"X": [x], "Out": [torch.rand(2, 4)],
                 "Out@GRAD": [torch.rand(2, 4)]})


# -- the reference's program tests on its small conv net -------------------

def conv_net(fluid, unique, delayed_net=False):
    """``tests/ops/test_fp8_activations.py``'s nets: conv -> relu -> conv
    -> (+residual) -> relu -> avg pool -> fc (``delayed_net``: conv
    without bias -> batch_norm -> relu -> avg pool -> fc), SGD(0.1),
    amp. The stores follow the environment at build and run time."""
    with unique.guard():
        prog, startup = fluid.Program(), fluid.Program()
        prog.random_seed = startup.random_seed = 5
        with fluid.program_guard(prog, startup):
            img = fluid.layers.data(name="img", shape=[8, 8, 8, 4],
                                    dtype="float32", append_batch_size=False)
            lbl = fluid.layers.data(name="lbl", shape=[8, 1], dtype="int64",
                                    append_batch_size=False)
            if delayed_net:
                c = fluid.layers.conv2d(input=img, num_filters=8,
                                        filter_size=3, padding=1,
                                        data_format="NHWC", bias_attr=False)
                r2 = fluid.layers.relu(fluid.layers.batch_norm(
                    c, data_layout="NHWC"))
            else:
                c1 = fluid.layers.conv2d(input=img, num_filters=8,
                                         filter_size=3, padding=1,
                                         data_format="NHWC")
                r1 = fluid.layers.relu(c1)
                c2 = fluid.layers.conv2d(input=r1, num_filters=8,
                                         filter_size=3, padding=1,
                                         data_format="NHWC")
                r2 = fluid.layers.relu(fluid.layers.elementwise_add(x=c2,
                                                                    y=r1))
            pooled = fluid.layers.pool2d(r2, pool_type="avg",
                                         global_pooling=True,
                                         data_format="NHWC")
            flat = fluid.layers.reshape(pooled, [8, 8])
            logits = fluid.layers.fc(input=flat, size=3)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, lbl))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        fluid.enable_mixed_precision(prog)
    return prog, startup, loss


def net_feed(scale=1.0):
    rng = np.random.RandomState(0)
    return {"img": (rng.rand(8, 8, 8, 4) * scale).astype(np.float32),
            "lbl": rng.randint(0, 3, (8, 1)).astype(np.int64)}


def _set_env(monkeypatch, acts, conv_out="0"):
    for name, value in (("PADDLE_TPU_FP8_ACTS", acts),
                        ("PADDLE_TPU_FP8_CONV_OUT", conv_out)):
        if value in ("", "0"):
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)


def train_both(monkeypatch, acts, conv_out="0", steps=6, delayed_net=False,
               feed_scale=1.0, eager_reference=False):
    """The net in both packages from the reference's startup state (built
    and run under the same environment): (reference losses, port losses,
    reference scope values, port scope, port program). With
    ``eager_reference`` the reference runs under ``jax.disable_jit``,
    so every value it stores is rounded to bf16 first, as the port's
    are."""
    _set_env(monkeypatch, acts, conv_out)
    jprog, jstart, jloss = conv_net(jfluid, junique, delayed_net)
    pprog, _, ploss = conv_net(pfluid, punique, delayed_net)
    assert [op.type for op in pprog.global_block().ops] == \
        [op.type for op in jprog.global_block().ops]
    feed = net_feed(feed_scale)
    with jscope_guard(JScope()), (jax.disable_jit() if eager_reference
                                  else contextlib.nullcontext()):
        exe = jfluid.Executor(jfluid.TPUPlace())
        exe.run(jstart)
        state = {n: np.asarray(v) for n, v in jglobal_scope().vars.items()}
        jl = [float(np.asarray(exe.run(jprog, feed=feed,
                                       fetch_list=[jloss])[0]).ravel()[0])
              for _ in range(steps)]
        jvars = {n: np.asarray(v) for n, v in jglobal_scope().vars.items()}
    scope = scope_from_jax(state, device="cpu")
    exe = pfluid.Executor(pfluid.CPUPlace())
    pl = [float(exe.run(pprog, feed=feed, fetch_list=[ploss],
                        scope=scope)[0].ravel()[0]) for _ in range(steps)]
    return jl, pl, jvars, scope, pprog


def test_fp8_acts_train_and_match_bf16(monkeypatch):
    _, ref, _, _, _ = train_both(monkeypatch, "0")
    jf8, f8, _, _, _ = train_both(monkeypatch, "1")
    assert f8[-1] < f8[0], f8
    np.testing.assert_allclose(f8, ref, rtol=0.15, atol=0.05)
    np.testing.assert_allclose(f8, jf8, rtol=0.02)


class _Probe:
    """Wraps the executor's ``trace_ops`` to keep every value of the step
    (no liveness drops) and hand the env to ``seen``."""

    def __init__(self, monkeypatch):
        self.envs = []
        real = pexecutor.trace_ops

        def probe(block, env, **kw):
            kw["drop"] = None
            out = real(block, env, **kw)
            self.envs.append((block, dict(out)))
            return out
        monkeypatch.setattr(pexecutor, "trace_ops", probe)

    def values(self, pred):
        """(op type, name, value) of every output of the ops ``pred``
        accepts."""
        for block, env in self.envs:
            for op in block.ops:
                if pred(op):
                    for names in op.outputs.values():
                        for n in names:
                            if n in env:
                                yield op.type, n, env[n]


@pytest.mark.parametrize("conv_out", ["0", "1", "e5m2", "scaled", "delayed"])
def test_fp8_backward_never_quantizes_grads(monkeypatch, conv_out):
    _set_env(monkeypatch, "1", conv_out)
    prog, startup, loss = conv_net(pfluid, punique)
    probe = _Probe(monkeypatch)
    with pfluid.scope_guard(pfluid.Scope()):
        exe = pfluid.Executor(pfluid.CPUPlace())
        exe.run(startup)
        probe.envs.clear()
        (lv,) = exe.run(prog, feed=net_feed(), fetch_list=[loss])
    assert np.isfinite(lv).all()
    grads = list(probe.values(lambda op: op.type.endswith("_grad")))
    assert len(grads) > 10
    leaked = [(t, n) for t, n, v in grads
              if getattr(v, "dtype", None) in FP8_DTYPES]
    assert not leaked, "fp8 leaked into gradients: %r" % leaked


@pytest.mark.parametrize("conv_out,want", [
    ("0", torch.bfloat16), ("1", E4M3), ("e4m3", E4M3), ("e5m2", E5M2),
    ("scaled", ScaledFp8), ("delayed", ScaledFp8)])
def test_fp8_relu_and_conv_outputs_are_stored(monkeypatch, conv_out, want):
    """relu outputs are e4m3 under the flag; conv outputs take the
    conv-out mode's storage (the reference's relu and conv-out
    experiment tests). Each relu here reads the bf16 sum of a conv
    output and its bias (or residual), so it stores e4m3 under every
    conv-out mode, as the reference's does."""
    _set_env(monkeypatch, "1", conv_out)
    prog, startup, loss = conv_net(pfluid, punique)
    probe = _Probe(monkeypatch)
    with pfluid.scope_guard(pfluid.Scope()):
        exe = pfluid.Executor(pfluid.CPUPlace())
        exe.run(startup)
        probe.envs.clear()
        (lv,) = exe.run(prog, feed=net_feed(), fetch_list=[loss])
    assert np.isfinite(lv).all()
    relus = [v for _, _, v in probe.values(lambda op: op.type == "relu")]
    assert len(relus) == 2 and all(v.dtype == E4M3 for v in relus)
    outs = [op.outputs["Output"][0] for op in prog.global_block().ops
            if op.type == "conv2d"]
    got = [env[n] for _, env in probe.envs for n in outs if n in env]
    assert len(got) == 2
    for v in got:
        assert isinstance(v, want) if want is ScaledFp8 else v.dtype == want


def test_delayed_scaled_fp8_conv_out(monkeypatch):
    """The delayed scale state: threaded in and out under one name, the
    loss falling over 8 steps, and the scale after them within 1e-3
    relative of the reference's, both from the reference's startup
    state (carried with ``convert.scope_from_jax``). The reference runs
    eagerly: under jit XLA takes the first step's amax (the seed) from
    the conv's fp32 sums before their bf16 rounding, and every later
    scale inherits that factor (measured 1.3e-3 apart; eager: equal)."""
    jl, pl, jvars, scope, prog = train_both(
        monkeypatch, "1", "delayed", steps=8, delayed_net=True,
        feed_scale=4.0, eager_reference=True)
    conv = next(op for op in prog.global_block().ops if op.type == "conv2d")
    (name,) = conv.inputs["Fp8Scale"]
    assert conv.outputs["Fp8ScaleOut"] == [name]
    scale = float(scope.find_var(name).reshape(-1)[0])
    ref = float(jvars[name].ravel()[0])
    assert 0 < scale < 1.0 and abs(scale - ref) <= 1e-3 * abs(ref), \
        (scale, ref)
    assert np.isfinite(pl).all() and pl[-1] < pl[0], pl
    np.testing.assert_allclose(pl, jl, rtol=0.02)


def test_fp8_fetches_widen_to_fp32(monkeypatch):
    """A fetched e4m3 relu output comes back as float32 numpy, its values
    the stored ones; a fetched ``ScaledFp8`` comes back as a
    ``ScaledFp8`` of numpy (the reference returns the object itself);
    ``check_nan_inf`` scans fp8 widened and catches the NaN an e4m3
    store gives past 464."""
    _set_env(monkeypatch, "1", "scaled")
    prog, startup, loss = conv_net(pfluid, punique)
    block = prog.global_block()
    relu = next(op for op in block.ops if op.type == "relu").outputs["Out"][0]
    conv = next(op for op in block.ops
                if op.type == "conv2d").outputs["Output"][0]
    with pfluid.scope_guard(pfluid.Scope()):
        exe = pfluid.Executor(pfluid.CPUPlace())
        exe.run(startup)
        r, c, lv = exe.run(prog, feed=net_feed(), fetch_list=[relu, conv,
                                                                loss])
        h = exe.run(prog, feed=net_feed(), fetch_list=[relu, conv],
                    return_numpy=False)
        r2, c2 = h.numpy()
    assert r.dtype == np.float32 and (r >= 0).all()
    np.testing.assert_array_equal(
        torch.from_numpy(r).to(E4M3).float().numpy(), r)
    assert isinstance(c, ScaledFp8) and c.data.dtype == np.float32
    assert c.scale.dtype == np.float32 and c.scale.shape == ()
    assert c.dequant(torch.float32).shape == (8, 8, 8, 8)
    assert isinstance(h[1], ScaledFp8) and h[1].dtype == E4M3
    assert r2.dtype == np.float32 and isinstance(c2, ScaledFp8)
    # check_nan_inf over fp8: e4m3 conv outputs past 464 are NaN
    _set_env(monkeypatch, "1", "1")
    prog, startup, loss = conv_net(pfluid, punique)
    conv = next(op for op in prog.global_block().ops
                if op.type == "conv2d").outputs["Output"][0]
    monkeypatch.setattr(pflags, "check_nan_inf", True)
    with pfluid.scope_guard(pfluid.Scope()):
        exe = pfluid.Executor(pfluid.CPUPlace())
        exe.run(startup)
        (ok,) = exe.run(prog, feed=net_feed(), fetch_list=[conv])
        assert np.isfinite(ok).all()
        with pytest.raises(FloatingPointError, match="NaN/Inf"):
            exe.run(prog, feed=net_feed(1e4), fetch_list=[conv])
