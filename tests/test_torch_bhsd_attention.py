"""The port's per-head (bhsd) and dense-mask attention against the JAX
package on the CPU.

Kernels' plain versions (what CPU tensors take) against the reference's
Pallas kernels, run as its own tests run them on the CPU: in interpret
mode through a monkeypatched ``pl.pallas_call``, at seq 512 (one
512-block), batch 2-3, heads 2-4 over kv heads 1-4, head_dim 16 and 32,
fp32:
- K6-fwd against ``_flash_fwd_impl(layout="bhsd")`` without a mask, with
  a factored padding mask and under dense [b|1, h|1, s, s] masks (one
  fully masked query row), causal and not, GQA;
- K6-dQ/dKV against ``_flash_bwd_impl(layout="bhsd")`` (full heads, as
  the reference's bhsd backward takes them) and the GQA backward against
  ``flash_attention``'s vjp (its expand-and-sum path): those two in
  ``test_torch_bhsd_attention_backward.py``, which takes this module's
  helpers;
- K1-dense against ``_flash_fwd_bshd`` under a dense [b|1, 1, s, s] mask.
Tolerance: within 5e-6 of each tensor's largest magnitude, entries at the
-1e30 mask value equal (both sides compute in fp32 and differ in
summation order only: test_torch_flash_attention.py's bound).
bf16 cases of K6-fwd (no mask, factored, each dense mask) and
K6-dQ/dKV: the same inputs cast to bf16, where the TPU's K6 rounds P and
dS to bf16 before each product; every element within 2 bf16 ulps of the
reference tensor's largest magnitude and at most 1% of them differing at
all (lse, fp32, as above); plain versions that keep P and dS in fp32
fail it, with 37-43% of the elements differing. The reference's blocks
are pinned to the port's key tile (``PADDLE_TPU_FLASH_BLOCK_Q/K``): an
online softmax rounds P at each tile's running max, so the forward's
rounding follows the tile width. Its backward takes the reference's (o,
lse), the same residuals on both sides; batch 2, and only rows with a
visible key (the average of a fully masked row follows the blocks the
kernel visits).

The ops through both packages' ``Executor`` and ``append_backward``:
``fused_attention`` in bhsd (no mask, factored, dense) and bshd (a
head-broadcast and a per-head dense mask), its ``Out`` and the gradients
of Q, K and V; the ``transpose`` op and its grad. fp32 within 1e-5
absolute + 1e-5 relative (summation order only; the reference's CPU
path is its XLA composition, the port's the kernels' plain versions).

Programs 1-3 of ``chip_smoke.build_lm_layout`` (bhsd causal; bhsd and
bshd under the prefix-LM mask) at 2 layers, d_model 64, 2 heads, vocab
64, batch 2, seq 128, from one state (``scope_from_jax``), 3 Adam steps:
the tolerances of test_torch_train.py — fp32 losses within 1e-5
relative and every final persistable within 1e-5 relative + 5e-5
absolute (the key bias, whose gradient is rounding noise, left out);
under amp losses within 5e-3 relative.
"""

from tests import torch_threads  # noqa: F401  (first)
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as jfluid
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.ops import pallas_attention as jpa

import paddle_tpu_torch as pfluid
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.ops import flash_attention as fa
from tests.test_torch_flash_attention import assert_bf16_close

S = 512
FP32 = dict(atol=1e-5, rtol=1e-5)


def assert_close(name, got, want):
    """Within 5e-6 of ``want``'s largest finite magnitude; entries at the
    -1e30 mask value (a fully masked row's lse) equal."""
    got, want = np.asarray(got), np.asarray(want)
    finite = np.abs(want) < 1e29
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=name)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=5e-6 * np.abs(want[finite]).max(),
                               err_msg=name)


def pin_blocks(monkeypatch, d):
    """The reference's flash blocks at the port's key tile."""
    tile = str(fa.key_tile(d))
    monkeypatch.setattr(jpa, "_BQ_ENV", tile)
    monkeypatch.setattr(jpa, "_BK_ENV", tile)


def seen_rows(b, h, causal, valid=None, m=None):
    """[b, h, S] bool: query rows that see at least one key."""
    vis = np.ones((b, h, S, S), bool)
    if causal:
        vis &= np.tril(np.ones((S, S), bool))
    if valid is not None:
        vis &= valid[:, None, None, :]
    if m is not None:
        vis &= m
    return vis.any(-1)


def to_bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def inputs(b, h, hkv, d, seed=0):
    """q, k, v, dO in bhsd and the factored mask's valid [b, s] (row 1 a
    padded tail, row 2 fully padded when b > 2)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, S, d).astype(np.float32)
    k = rng.randn(b, hkv, S, d).astype(np.float32)
    v = rng.randn(b, hkv, S, d).astype(np.float32)
    do = rng.randn(b, h, S, d).astype(np.float32)
    valid = np.ones((b, S), bool)
    valid[1, S - 70:] = False
    valid[2:] = False
    return q, k, v, do, valid


def dense(b, h, mb, mh, seed=1):
    """A dense [mb|1, mh|1, s, s] bool mask (mb = "b": b rows, mh = "h": h
    heads), each key visible with probability 0.7, query row 5 of its
    first slice fully masked."""
    rng = np.random.RandomState(seed)
    m = rng.rand(b if mb == "b" else 1, h if mh == "h" else 1, S, S) < 0.7
    m[0, 0, 5] = False
    return m


def jnp_all(*xs):
    return [jnp.asarray(x) for x in xs]


def torch_all(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


MASKS = ["none", "factored", (1, 1), ("b", 1), (1, "h"), ("b", "h")]


def mask_id(m):
    return m if isinstance(m, str) else "dense-%s-%s" % m


@pytest.mark.parametrize(
    "mask,bf16", [(m, False) for m in MASKS] + [(m, True) for m in MASKS],
    ids=[mask_id(m) for m in MASKS] + [mask_id(m) + "-bf16" for m in MASKS])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("h,hkv,d", [(4, 4, 16), (4, 1, 32), (2, 2, 32)],
                         ids=["mha", "gqa", "d32"])
def test_k6_forward_plain_matches_the_pallas_kernel(interpret, monkeypatch,
                                                     h, hkv, d, causal, mask,
                                                     bf16):
    b = 2 if bf16 else 3
    q, k, v, _, valid = inputs(b, h, hkv, d)
    scale = 1.0 / np.sqrt(d)
    m = None
    if mask == "none":
        jm = pm = kv = None
    elif mask == "factored":
        jm, kv, pm = (jnp.asarray(valid), jnp.asarray(valid)), \
            torch.from_numpy(valid), None
    else:
        m = dense(b, h, *mask)
        jm, kv, pm = jnp.asarray(m), None, torch.from_numpy(m)
    jin, tin = jnp_all(q, k, v), torch_all(q, k, v)
    if bf16:
        pin_blocks(monkeypatch, d)
        jin = [x.astype(jnp.bfloat16) for x in jin]
        tin = [x.to(torch.bfloat16) for x in tin]
    jo, jlse = jpa._flash_fwd_impl(*jin, scale, causal, save_lse=True,
                                   mask=jm, layout="bhsd")
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(*tin, scale, causal, kv, pm, layout="bhsd")
    assert fa.launches == before        # CPU tensors launch nothing
    assert tuple(o.shape) == q.shape and tuple(lse.shape) == (b * h, S, 8)
    assert_close("lse", lse.numpy(), jlse)
    if bf16:
        seen = seen_rows(b, h, causal, None if kv is None else valid, m)
        assert_bf16_close("o", o.float().numpy()[seen],
                          np.asarray(jo.astype(jnp.float32))[seen])
        return
    assert_close("o", o.numpy(), jo)
    if pm is not None:   # the fully masked row is V's uniform average
        vbar = v[0].mean(axis=1).repeat(h // hkv, axis=0)
        np.testing.assert_allclose(o[0, 0, 5].numpy(), vbar[0], atol=1e-5)


@pytest.mark.parametrize(
    "mb,bf16", [(1, False), ("b", False), (1, True), ("b", True)],
    ids=["mask-b1", "mask-bb", "mask-b1-bf16", "mask-bb-bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_k1_dense_plain_matches_the_pallas_kernel(interpret, h, hkv, causal,
                                                  mb, bf16):
    """bf16: the inputs cast to bf16, the reference's blocks at the port's
    key tile; K1 keeps P in fp32 (its tensor-core body as hi + lo), so O
    is held to ``assert_bf16_close`` over the rows that see a key (a
    fully masked row averages the blocks the reference visits) and the
    fp32 Lse as in fp32."""
    b, d = 2, 32
    q, k, v = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
               for x in inputs(b, h, hkv, d, seed=4)[:3])
    m = dense(b, h, mb, 1, seed=5)
    scale = 1.0 / np.sqrt(d)
    jin, tin = jnp_all(q, k, v), torch_all(q, k, v)
    block = S
    if bf16:
        block = fa.key_tile(d)
        jin = [x.astype(jnp.bfloat16) for x in jin]
        tin = [x.to(torch.bfloat16) for x in tin]
    with jpa._block_ctx(block, block):
        jo, jlse = jpa._flash_fwd_bshd(*jin, scale, causal, save_lse=True,
                                       mask=jnp.asarray(m))
    o, lse = fa.flash_fwd(*tin, scale, causal, mask=torch.from_numpy(m))
    assert_close("lse", lse.numpy(), jlse)
    if bf16:
        seen = seen_rows(b, h, causal, None, m)
        assert_bf16_close(
            "o", o.float().numpy().transpose(0, 2, 1, 3)[seen],
            np.asarray(jo.astype(jnp.float32)).transpose(0, 2, 1, 3)[seen])
        return
    assert_close("o", o.numpy(), jo)


def cancelling_row(d, n_keys):
    """bhsd q, k, v of one head with ``n_keys`` positions whose score
    (0, 0) is a dot product of bf16 terms 2^24, 1 (x d - 2) and -2^24:
    an fp32 sum in index order loses the ones and takes it to 0, the
    exact sum is d - 2. Key 1 scores 0; V is ones at key 0, zeros
    elsewhere. Returns (q, k, v, in_order, exact)."""
    q = np.ones((1, 1, n_keys, d), np.float32)
    k = np.zeros((1, 1, n_keys, d), np.float32)
    q[..., [0, -1]] = 2.0 ** 12
    k[0, 0, 0] = 1.0
    k[0, 0, 0, [0, -1]] = [2.0 ** 12, -2.0 ** 12]
    v = np.zeros((1, 1, n_keys, d), np.float32)
    v[0, 0, 0] = 1.0
    terms = (q[0, 0, 0] * k[0, 0, 0]).astype(np.float32)
    in_order = np.float32(0)
    for t in terms:                  # an fp32 sum loses the ones
        in_order = np.float32(in_order + t)
    exact = float(np.dot(q[0, 0, 0].astype(np.float64),
                         k[0, 0, 0].astype(np.float64)))
    return q, k, v, in_order, exact


def test_k6_forward_plain_takes_the_correctly_rounded_scores():
    """Under bf16 the plain bhsd forward without a dense mask sums each
    Q.K^T in float64 and rounds it once, as K6's tensor-core forward sums
    it on the FP64 tensor cores: a dot product of bf16 terms 2^24, 1 (x
    14) and -2^24, which an fp32 sum in index order takes to 0, comes
    out 14, so the row's softmax and Lse follow the float64 answer (from
    a score of 0 the Lse would be log 2)."""
    q, k, v, in_order, exact = cancelling_row(16, 2)
    assert (in_order, exact) == (0.0, 14.0)
    t = [x.to(torch.bfloat16) for x in torch_all(q, k, v)]
    for x, x32 in zip(t, torch_all(q, k, v)):    # bf16 holds every term
        assert torch.equal(x.float(), x32)
    o, lse = fa.flash_fwd(*t, 1.0, False, layout="bhsd")
    s = np.array([exact, 0.0])                     # the scores of row 0
    want_lse = np.log(np.exp(s).sum())
    np.testing.assert_allclose(lse[0, 0].numpy(), want_lse, rtol=1e-6)
    np.testing.assert_allclose(o[0, 0, 0].float().numpy(),
                               np.exp(s[0] - want_lse), rtol=2 ** -8)


def test_k6_dense_forward_plain_takes_the_correctly_rounded_scores():
    """Under a dense mask too, the plain bhsd bf16 forward takes S in
    float64, as K6-fwd-dense's tensor-core body sums it: row 0's first
    score is the cancelling dot product of ``cancelling_row`` (exactly
    14, 0 in fp32 in index order), its second 0, and the mask hides its
    third key, whose score of 4096 would take the whole softmax. P of
    key 0 is then exp(14 - Lse), which rounds to bf16 1.0 (from an fp32
    score of 0 it would be 0.5), and the Lse log(e^14 + 1). A plain
    version that sums S in fp32 under a dense mask (the forward's split
    before K6-fwd-dense ran on the tensor cores) fails it."""
    q, k, v, in_order, exact = cancelling_row(16, 3)
    k[0, 0, 2, 0] = 1.0                  # score (0, 2) = 2^12: hidden
    mask = np.ones((1, 1, 3, 3), bool)
    mask[0, 0, 0, 2] = False
    t = [x.to(torch.bfloat16) for x in torch_all(q, k, v)]
    o, lse = fa.flash_fwd(*t, 1.0, False, mask=torch.from_numpy(mask),
                          layout="bhsd")
    s = np.array([exact, 0.0])                     # row 0's visible scores
    want_lse = np.log(np.exp(s).sum())
    np.testing.assert_allclose(lse[0, 0].numpy(), want_lse, rtol=1e-6)
    np.testing.assert_allclose(o[0, 0, 0].float().numpy(),
                               np.exp(s[0] - want_lse), rtol=2 ** -8)


def test_dense_mask_autograd_recomputes_through_the_composition():
    """Under a dense mask the backward of ``flash_fwd_saving_lse`` is the
    plain composition's vjp: it launches nothing and equals autograd of
    ``dot_product_attention`` (the same function: exactly)."""
    from paddle_tpu_torch.ops.attention import dot_product_attention
    q, k, v, do, _ = inputs(2, 4, 2, 16, seed=6)
    m = torch.from_numpy(dense(2, 4, "b", "h"))
    leaves = [t.requires_grad_() for t in torch_all(q, k, v)]
    o, lse = fa.flash_fwd_saving_lse(*leaves, None, True, m, "bhsd")
    assert not lse.requires_grad
    g = torch.from_numpy(do)
    got = torch.autograd.grad(o, leaves, g)
    ref = dot_product_attention(*leaves, causal=True, mask=m)
    want = torch.autograd.grad(ref, leaves, g)
    np.testing.assert_allclose(o.detach().numpy(), ref.detach().numpy(),
                               **FP32)
    for a, b_ in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b_.numpy())
    with pytest.raises(ValueError):       # no saved backward takes it
        fa.flash_bwd_from_saved(*leaves, o, lse, g, None, True, m, "bhsd")


def test_wrappers_check_layouts_and_dense_masks():
    meta = dict(device="meta")
    q = torch.empty(2, 4, S, 16, **meta)
    k = torch.empty(2, 2, S, 16, **meta)
    before = dict(fa.launches)
    with pytest.raises(ValueError):              # per-head mask in bshd
        fa.flash_fwd(q.transpose(1, 2), k.transpose(1, 2),
                     k.transpose(1, 2),
                     mask=torch.ones(2, 4, S, S, dtype=torch.bool, **meta))
    with pytest.raises(ValueError):              # mask of the wrong length
        fa.flash_fwd(q, k, k, layout="bhsd",
                     mask=torch.ones(1, 1, S, 8, dtype=torch.bool, **meta))
    with pytest.raises(ValueError):              # two masks at once
        fa.flash_fwd(q, k, k, k_valid=torch.ones(2, S, dtype=torch.bool),
                     mask=torch.ones(1, 1, S, S, dtype=torch.bool),
                     layout="bhsd")
    with pytest.raises(TypeError):               # a float mask
        fa.flash_fwd(q, k, k, layout="bhsd",
                     mask=torch.ones(1, 1, S, S, **meta))
    with pytest.raises(ValueError):              # not a CUDA device
        fa.flash_fwd(q, k, k, layout="bhsd",
                     mask=torch.ones(1, 4, S, S, dtype=torch.bool, **meta))
    with pytest.raises(ValueError):              # delta in bshd's layout
        fa.flash_bwd_dq(q, k, k, q, torch.empty(8, S, 8, **meta),
                        torch.empty(2, S, 4, **meta), layout="bhsd")
    assert fa.launches == before
    names = {fa.kernel_name(r, lay) for r in ("fwd", "bwd_dq", "bwd_dkv")
             for lay in ("bshd", "bhsd")}
    names |= {fa.kernel_name("fwd", lay, True) for lay in ("bshd", "bhsd")}
    assert names == {n for n in fa.launches if "segment" not in n}


DISPATCH_CASES = [
    # (layout, h, hkv, d, mask, path): the reference's supports/dispatch
    ("bhsd", 4, 2, 16, None, "saved"),
    ("bshd", 4, 2, 16, "factored", "saved"),
    ("bshd", 4, 2, 16, "segments", "saved"),
    ("bhsd", 4, 2, 16, "segments", "plain"),       # segment ids: bshd only
    ("bhsd", 71, 1, 64, None, "saved"),            # Falcon-7B: 71 on 1 kv
    ("bshd", 71, 1, 64, (1, 1), "dense"),
    ("bhsd", 4, 2, 16, ("b", "h"), "dense"),
    ("bshd", 4, 2, 16, ("b", 1), "dense"),
    ("bshd", 4, 2, 16, (1, "h"), "plain"),         # per-head mask in bshd
    ("bhsd", 4, 2, 16, "short", "plain"),          # a mask of another shape
    ("bhsd", 4, 4, 288, None, "plain"),            # head_dim above 256
]


@pytest.mark.parametrize("layout,h,hkv,d,mask,path", DISPATCH_CASES)
def test_dispatch_path_follows_the_reference(layout, h, hkv, d, mask, path):
    """``dispatch_path`` decides from shapes alone, as the reference's
    ``supports`` does: no limit on the query group (a group above 64
    heads spans several kernel blocks), head_dim up to 256, dense masks
    [b|1, h|1, s, s] in bhsd and [b|1, 1, s, s] in bshd."""
    from paddle_tpu_torch.ops.attention import dispatch_path
    from paddle_tpu_torch.ops.segment_mask import SegmentIds
    b, meta = 2, dict(device="meta")
    shape = (lambda n: (b, n, S, d)) if layout == "bhsd" else \
        (lambda n: (b, S, n, d))
    q, k = torch.empty(*shape(h), **meta), torch.empty(*shape(hkv), **meta)
    ids = torch.zeros(b, S, dtype=torch.int32, **meta)
    if isinstance(mask, tuple):
        m = torch.ones(b if mask[0] == "b" else 1,
                       h if mask[1] == "h" else 1, S, S, dtype=torch.bool,
                       **meta)
    else:
        m = {None: None, "segments": SegmentIds(ids, ids),
             "factored": (torch.ones(b, S, dtype=torch.bool, **meta),) * 2,
             "short": torch.ones(1, 1, S, 8, dtype=torch.bool,
                                 **meta)}[mask]
    assert dispatch_path(q, k, m, layout) == path


# -- the ops through both packages ------------------------------------------

def run_program(fluid, build, feed, fetch, state=None):
    """Build under ``fluid``'s unique-name guard, run startup (or take
    ``state``), one step; (fetched numpy arrays, startup state)."""
    with fluid.unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            outs = build(fluid)
            fluid.append_backward(outs[-1])
    names = [o.name if hasattr(o, "name") else o for o in outs[:-1]] + fetch
    block = prog.global_block()
    fetch_vars = [block.var(n) for n in names]
    if fluid is jfluid:
        scope = JScope()
        with jscope_guard(scope):
            exe = jfluid.Executor(jfluid.TPUPlace())
            exe.run(startup)
            state = {n: np.asarray(v) for n, v in scope.vars.items()
                     if v is not None}
            got = exe.run(prog, feed=feed, fetch_list=fetch_vars)
        return [np.asarray(x, np.float32) for x in got], state
    scope = scope_from_jax(state, device="cpu")
    got = pfluid.Executor(pfluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch_vars, scope=scope)
    return [np.asarray(x, np.float32) for x in got], state


OP_CASES = [("bhsd", "none", True), ("bhsd", "factored", False),
            ("bhsd", ("b", "h"), False), ("bhsd", (1, "h"), True),
            ("bshd", ("b", 1), False), ("bshd", ("b", "h"), True)]


@pytest.mark.parametrize("layout,mask,causal", OP_CASES, ids=[
    "%s-%s-%s" % (lay, m if isinstance(m, str) else "dense-%s-%s" % m,
                  "causal" if c else "full") for lay, m, c in OP_CASES])
def test_fused_attention_and_its_grad_through_both_executors(layout, mask,
                                                             causal):
    """Q, K, V as trainable feeds, ``fused_attention`` (the bshd per-head
    mask is the plain composition's case), then a projection and a mean:
    Out and the gradients of Q, K and V agree."""
    b, h, d, s = 3, 4, 16, 128
    rng = np.random.RandomState(7)
    shape = [b, h, s, d] if layout == "bhsd" else [b, s, h, d]
    feed = {n: rng.randn(*shape).astype(np.float32) for n in "qkv"}
    valid = np.ones((b, s), np.float32)
    valid[1, s - 40:] = 0.0
    valid[2] = 0.0
    if mask == "factored":
        feed["valid"] = valid
    elif mask != "none":
        m = rng.rand(b if mask[0] == "b" else 1,
                     h if mask[1] == "h" else 1, s, s) < 0.7
        m[0, 0, 5] = False
        feed["mask"] = m

    def build(fluid):
        L = fluid.layers
        q, k, v = (L.data(name=n, shape=shape, dtype="float32",
                          append_batch_size=False, stop_gradient=False)
                   for n in "qkv")
        inputs = {"Q": [q], "K": [k], "V": [v]}
        if mask == "factored":
            vd = L.data(name="valid", shape=[b, s], dtype="float32",
                        append_batch_size=False)
            inputs.update(QValid=[vd], KValid=[vd])
        elif mask != "none":
            inputs["Mask"] = [L.data(name="mask", shape=list(m.shape),
                                     dtype="bool", append_batch_size=False)]
        helper = fluid.layer_helper.LayerHelper("fused_attention")
        out = helper.create_tmp_variable(dtype="float32")
        lse = helper.create_tmp_variable(dtype="float32")
        lse.stop_gradient = True
        attrs = {"causal": causal, "scale": 0.25}
        if layout == "bshd":
            attrs["layout"] = "bshd"
        helper.append_op(type="fused_attention", inputs=inputs,
                         outputs={"Out": [out], "Lse": [lse]}, attrs=attrs)
        loss = L.mean(L.fc(input=out, size=3, num_flatten_dims=3))
        return [out, lse, loss]

    grads = ["q@GRAD", "k@GRAD", "v@GRAD"]
    jgot, state = run_program(jfluid, build, feed, grads)
    pgot, _ = run_program(pfluid, build, feed, grads, state)
    for name, a, b_ in zip(["Out", "Lse"] + grads, pgot, jgot):
        if name == "Lse":      # the reference's CPU path saves zeros
            assert a.shape == (b * h, s, 8) and np.isfinite(a).all()
            continue
        np.testing.assert_allclose(a, b_, err_msg=name, **FP32)
    if mask == "factored":     # padded query rows come out as exact zeros
        out = pgot[0] if layout == "bshd" else pgot[0].transpose(0, 2, 1, 3)
        assert not out[1, s - 40:].any() and not out[2].any()


@pytest.mark.parametrize("perm", [[0, 2, 1, 3], [3, 1, 0, 2]])
def test_transpose_op_and_its_grad(perm):
    x = np.random.RandomState(8).randn(2, 3, 4, 5).astype(np.float32)

    def build(fluid):
        xv = fluid.layers.data(name="x", shape=[2, 3, 4, 5],
                               dtype="float32", append_batch_size=False,
                               stop_gradient=False)
        y = fluid.layers.transpose(xv, perm=perm)
        assert list(y.shape) == [[2, 3, 4, 5][p] for p in perm]
        loss = fluid.layers.mean(fluid.layers.fc(
            input=y, size=2, num_flatten_dims=3))
        return [y, loss]

    jgot, state = run_program(jfluid, build, {"x": x}, ["x@GRAD"])
    pgot, _ = run_program(pfluid, build, {"x": x}, ["x@GRAD"], state)
    np.testing.assert_array_equal(pgot[0], x.transpose(perm))
    for a, b_ in zip(pgot, jgot):
        np.testing.assert_allclose(a, b_, **FP32)


# -- programs 1-3 of chip_smoke.build_lm_layout ----------------------------

B, T, V, LAYERS, DIM, HEADS = 2, 128, 64, 2, 64, 2
STEPS, LR = 3, 1e-3


def three_steps(fluid, layout, mask_kind, amp, feed, state=None):
    prog, startup, loss = cs.build_lm_layout(
        fluid, layout, mask_kind, LAYERS, B, T, amp=amp, vocab=V, dim=DIM,
        heads=HEADS, lr=LR)
    if fluid is jfluid:
        scope = JScope()
        with jscope_guard(scope):
            exe = jfluid.Executor(jfluid.TPUPlace())
            exe.run(startup)
            state = {n: np.asarray(v) for n, v in scope.vars.items()
                     if v is not None}
            losses = [float(np.asarray(exe.run(prog, feed=feed,
                                               fetch_list=[loss])[0])
                            .ravel()[0]) for _ in range(STEPS)]
            final = {n: np.asarray(scope.find_var(n), np.float32)
                     for n in state}
        return losses, state, final, prog
    scope = scope_from_jax(state, device="cpu")
    exe = pfluid.Executor(pfluid.CPUPlace())
    losses = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                            scope=scope)[0].ravel()[0]) for _ in range(STEPS)]
    final = {n: scope.find_var(n).float().numpy() for n in state}
    return losses, state, final, prog


PROGRAMS = [("bhsd", "none", False), ("bhsd", "prefix", False),
            ("bshd", "prefix", False), ("bhsd", "none", True)]


@pytest.mark.parametrize("layout,mask_kind,amp", PROGRAMS, ids=[
    "program1-bhsd-causal", "program2-bhsd-prefix", "program3-bshd-prefix",
    "program1-bhsd-causal-amp"])
def test_layout_programs_match_the_reference(layout, mask_kind, amp):
    feed = cs.lm_feed(B, T)
    feed["ids"] %= V
    feed["labels"] %= V
    if mask_kind == "prefix":
        feed["mask"] = cs.prefix_mask(B, T)
    jl, state, jfinal, jprog = three_steps(jfluid, layout, mask_kind, amp,
                                           feed)
    pl, _, pfinal, pprog = three_steps(pfluid, layout, mask_kind, amp, feed,
                                       state)
    types = [op.type for op in pprog.global_block().ops]
    assert types == [op.type for op in jprog.global_block().ops]
    assert types.count("fused_attention") == LAYERS
    assert types.count("transpose") == (4 * LAYERS if layout == "bhsd"
                                        else 0)
    assert all(np.isfinite(pl)) and pl[-1] < pl[0]
    np.testing.assert_allclose(pl, jl, rtol=5e-3 if amp else 1e-5)
    if amp:
        return
    key_bias = {"fc_%d.b_0" % (6 * i + 1) for i in range(LAYERS)}
    for name in sorted(jfinal):
        if any(name == kb or name.startswith(kb + "_moment")
               for kb in key_bias):
            continue
        np.testing.assert_allclose(pfinal[name], jfinal[name], rtol=1e-5,
                                   atol=5e-5, err_msg=name)
