"""Seq2seq NMT training (``bench_nmt.py``'s path) in the port against the
JAX package on the CPU.

- ``seq2seq_net`` at narrow widths (32 wide, vocab 100, batch 4, max
  length 12: ``benchmarks.nmt.build_program``'s program, and the same
  build through the JAX package): three ``Adam`` steps from the JAX
  startup state, fp32 and under ``enable_mixed_precision``.
  fp32: losses within 1e-5 relative, every final persistable within
  1e-5 relative + 5e-5 absolute (5% of one Adam step at lr 1e-3: Adam
  divides each grad by its own magnitude, so a weight with a near-zero
  grad moves by what its summation-order noise sets). amp: losses within
  5e-3 relative, each persistable's three-step update within 0.1
  relative L2 of the reference's (both round the fc outputs to bf16,
  not always at the same ulp; Adam turns that into whole steps for
  small grads). And under amp, the dtype of every value the program
  computes (forward and grads) equals the reference's.
- The decorator's batchers, bitwise the reference's.
- ``benchmarks.nmt``'s ``synthetic_samples``, ``make_feed``,
  ``nmt_step_flops`` and pooled schedule, equal to ``bench_nmt.py``'s.
- ``run_steps(n)`` on the CPU equal, bit for bit, to ``n`` ``run()``
  calls over a schedule with two padded shapes; the second shape's
  first dispatch a cache miss named ``feed_signature``.
- The bench's ``main`` at a tiny size under ``BENCH_FORCE_CPU=1``,
  printing ``bench_nmt.py``'s keys.
"""

import ast
import json
import random

import numpy as np
import pytest
import torch

import bench_nmt
import paddle_tpu as jfluid
from paddle_tpu import models as jmodels
from paddle_tpu import unique_name as junique
from paddle_tpu.data import decorator as jdec
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import profiler as pprofiler
from paddle_tpu_torch import unique_name as punique
from paddle_tpu_torch.benchmarks import nmt
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.data import decorator as pdec
from paddle_tpu_torch.observability import steps as psteps

from tests.test_torch_lod import JLoDArray, PLoDArray, to_port

W, V, BATCH, SEQ, STEPS = 32, 100, 4, 12, 3


def jax_build(amp, optimizer=True):
    """bench_nmt.py's build_program at W wide (its widths are fixed)."""
    with junique.guard():
        prog, startup = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(prog, startup):
            src = jfluid.layers.data(name="src_word_id", shape=[1],
                                     dtype="int64", lod_level=1)
            trg = jfluid.layers.data(name="target_language_word",
                                     shape=[1], dtype="int64", lod_level=1)
            lbl = jfluid.layers.data(name="target_language_next_word",
                                     shape=[1], dtype="int64", lod_level=1)
            logits = jmodels.seq2seq_net(src, trg, V, V, embedding_dim=W,
                                         encoder_size=W, decoder_size=W,
                                         with_softmax=False)
            cost = jfluid.layers.softmax_with_cross_entropy(logits, lbl)
            loss = jfluid.layers.mean(
                jfluid.layers.sequence_pool(cost, "sum"))
            if optimizer:
                jfluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
            else:
                jfluid.backward.append_backward(loss)
        jfluid.enable_mixed_precision(prog, amp)
    return prog, startup, loss


def port_build(amp):
    with punique.guard():
        prog, startup, loss, feed, _, _ = nmt.build_program(
            batch=BATCH, seq=SEQ, vocab=V, emb=W, hid=W, amp=amp)
    return prog, startup, loss, feed


def jax_state(startup):
    scope = JScope()
    with jscope_guard(scope):
        exe = jfluid.Executor(jfluid.TPUPlace())
        exe.run(startup)
    return scope, {n: np.asarray(v) for n, v in scope.vars.items()
                   if v is not None}


@pytest.mark.parametrize("amp", [False, True])
def test_seq2seq_three_adam_steps(amp):
    jprog, jstart, jloss = jax_build(amp)
    pprog, pstart, ploss, pfeed = port_build(amp)
    assert sorted(v.name for v in jprog.list_vars()) == \
        sorted(v.name for v in pprog.list_vars())
    assert [op.type for op in jprog.global_block().ops] == \
        [op.type for op in pprog.global_block().ops]
    feed = bench_nmt.make_feed(bench_nmt.synthetic_samples(BATCH, SEQ, V),
                               max_len=SEQ)
    for k in feed:
        np.testing.assert_array_equal(pfeed[k].data, feed[k].data)
    jscope, state = jax_state(jstart)
    with jscope_guard(jscope):
        exe = jfluid.Executor(jfluid.TPUPlace())
        jl = [float(np.asarray(exe.run(jprog, feed=feed,
                                       fetch_list=[jloss])[0]))
              for _ in range(STEPS)]
        jfinal = {n: np.asarray(jscope.find_var(n), np.float32)
                  for n in state}
    scope = scope_from_jax(state, device="cpu")
    exe = pfluid.Executor(pfluid.CPUPlace())
    pl = [float(exe.run(pprog, feed=pfeed, fetch_list=[ploss],
                        scope=scope)[0]) for _ in range(STEPS)]
    pfinal = {n: scope.find_var(n).float().numpy() for n in state}
    assert all(np.isfinite(pl)) and pl[-1] < pl[0]
    if not amp:
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
        for n in state:
            np.testing.assert_allclose(pfinal[n], jfinal[n], rtol=1e-5,
                                       atol=5e-5, err_msg=n)
        return
    np.testing.assert_allclose(pl, jl, rtol=5e-3)
    for n in state:
        if state[n].dtype.kind != "f":
            continue
        want = jfinal[n] - state[n]
        got = pfinal[n] - state[n]
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= 0.1, (n, err)


def test_amp_dtypes_follow_the_reference():
    """Every value of the amp program (forward and grads) in the port has
    the reference's dtype: bf16 fcs and embeddings, the fp32 recurrence
    (a bf16 input plus the fp32 bias), fp32 losses."""
    import jax
    from paddle_tpu.executor import trace_ops as jtrace
    from paddle_tpu_torch.executor import trace_ops as ptrace
    jprog, jstart, _ = jax_build(True, optimizer=False)
    with punique.guard():
        pprog, pstart = pfluid.Program(), pfluid.Program()
        with pfluid.program_guard(pprog, pstart):
            src = pfluid.layers.data(name="src_word_id", shape=[1],
                                     dtype="int64", lod_level=1)
            trg = pfluid.layers.data(name="target_language_word",
                                     shape=[1], dtype="int64", lod_level=1)
            lbl = pfluid.layers.data(name="target_language_next_word",
                                     shape=[1], dtype="int64", lod_level=1)
            logits = pfluid.models.seq2seq_net(
                src, trg, V, V, embedding_dim=W, encoder_size=W,
                decoder_size=W, with_softmax=False)
            cost = pfluid.layers.softmax_with_cross_entropy(logits, lbl)
            loss = pfluid.layers.mean(
                pfluid.layers.sequence_pool(cost, "sum"))
            pfluid.append_backward(loss)
        pfluid.enable_mixed_precision(pprog, True)
    _, state = jax_state(jstart)
    feed = bench_nmt.make_feed(bench_nmt.synthetic_samples(BATCH, SEQ, V),
                               max_len=SEQ)
    import jax.numpy as jnp
    jenv = {n: jnp.asarray(v) for n, v in state.items()}
    jenv.update({k: JLoDArray(jnp.asarray(v.data), jnp.asarray(v.length))
                 for k, v in feed.items()})
    jtrace(jprog.global_block(), jenv, step_key=jax.random.PRNGKey(0))
    penv = {n: torch.tensor(v) for n, v in state.items()}
    penv.update({k: PLoDArray(torch.from_numpy(v.data).long(),
                              torch.from_numpy(v.length))
                 for k, v in to_port(feed).items()})
    with torch.no_grad():
        ptrace(pprog.global_block(), penv, step_key=(0, 0))

    def dtype(v):
        v = v.data if isinstance(v, (JLoDArray, PLoDArray)) else v
        return str(v.dtype).replace("torch.", "")

    names = [n for n in jenv if n not in state and n not in feed and
             jenv[n] is not None]
    assert len(names) > 60
    differ = {n: (dtype(penv.get(n)), dtype(jenv[n])) for n in names
              if n in penv and dtype(penv[n]) != dtype(jenv[n])}
    assert not differ, differ
    assert dtype(penv["fc_0.tmp_0"]) == "bfloat16"       # the mul
    assert dtype(penv["lstm_0.tmp_0"]) == "float32"      # the recurrence
    assert dtype(penv["softmax_with_cross_entropy_0.tmp_1"]) == "float32"
    missing = set(names) - set(penv)
    # outputs the port skips because nothing reads them: each LSTM's
    # unread Cell / BatchCellPreAct and each pool's absent MaxIndex
    assert all(n.startswith(("lstm_", "sequence_pool_")) for n in missing), \
        missing


# -- the decorator ------------------------------------------------------------

def _samples(n, seed=0):
    return bench_nmt.synthetic_samples(n, 40, 1000, seed=seed)


def test_decorator_batchers_bitwise():
    samples = _samples(300)
    key = lambda s: len(s[0]) + len(s[1])     # noqa: E731
    for drop in (False, True):
        a = list(pdec.batch(lambda: iter(samples), 64, drop_last=drop)())
        b = list(jdec.batch(lambda: iter(samples), 64, drop_last=drop)())
        assert [[id(s) for s in x] for x in a] == \
            [[id(s) for s in x] for x in b]
    for n, m in ((0, 8), (1, 8), (17, 8), (40, 0), (40, 1), (33, None)):
        assert pdec.snap_length(n, m) == jdec.snap_length(n, m)
    assert pdec.default_length_key(samples[0]) == \
        jdec.default_length_key(samples[0])
    with pytest.raises(TypeError):
        pdec.default_length_key((1, 2))
    for shuffle in (False, True):
        for drop in (False, True):
            random.seed(3)
            a = list(pdec.pool_batch_by_length(
                lambda: iter(samples), 16, pool_factor=4, key=key,
                shuffle_batches=shuffle, drop_last=drop)())
            random.seed(3)
            b = list(jdec.pool_batch_by_length(
                lambda: iter(samples), 16, pool_factor=4, key=key,
                shuffle_batches=shuffle, drop_last=drop)())
            assert [[id(s) for s in x] for x in a] == \
                [[id(s) for s in x] for x in b]
            for bm in (None, 8, 40):
                assert pdec.pad_waste_fraction(
                    a, key=lambda s: len(s[1]), bucket_multiple=bm) == \
                    jdec.pad_waste_fraction(
                        b, key=lambda s: len(s[1]), bucket_multiple=bm)
    a = pdec.slice_length_pool(list(samples[:50]), 16, key=key,
                               rng=random.Random(5))
    b = jdec.slice_length_pool(list(samples[:50]), 16, key=key,
                               rng=random.Random(5))
    assert [[id(s) for s in x] for x in a] == [[id(s) for s in x] for x in b]
    # the flag's default
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags as pflags
    assert pflags.length_pool_factor == jflags.length_pool_factor == 16
    a = list(pdec.pool_batch_by_length(lambda: iter(samples), 8, key=key,
                                       shuffle_batches=False)())
    b = list(jdec.pool_batch_by_length(lambda: iter(samples), 8, key=key,
                                       shuffle_batches=False)())
    assert [[id(s) for s in x] for x in a] == [[id(s) for s in x] for x in b]


# -- the bench's pieces -------------------------------------------------------

def test_bench_inputs_equal_bench_nmt():
    for seed in (0, 1):
        a = nmt.synthetic_samples(50, 40, 30000, seed=seed)
        b = bench_nmt.synthetic_samples(50, 40, 30000, seed=seed)
        for (s1, t1), (s2, t2) in zip(a, b):
            assert s1.dtype == s2.dtype and t1.dtype == t2.dtype
            np.testing.assert_array_equal(s1, s2)
            np.testing.assert_array_equal(t1, t2)
    pairs = nmt.synthetic_samples(64, 40, 30000)
    for kw in ({"max_len": 40}, {"pad_to_multiple": 8}):
        fa, fb = nmt.make_feed(pairs, **kw), bench_nmt.make_feed(pairs, **kw)
        assert sorted(fa) == sorted(fb)
        for k in fa:
            assert fa[k].data.dtype == fb[k].data.dtype
            np.testing.assert_array_equal(fa[k].data, fb[k].data)
            np.testing.assert_array_equal(fa[k].length, fb[k].length)
    for args in ((1000, 1100, 64), (1, 2, 1)):
        assert nmt.nmt_step_flops(*args) == bench_nmt.nmt_step_flops(*args)
    assert nmt.nmt_step_flops(1920, 1920, 64, vocab=100) == \
        bench_nmt.nmt_step_flops(1920, 1920, 64, vocab=100)


def test_pooled_schedule_equals_bench_nmt_grouping():
    """The pooled schedule is bench_nmt.py main()'s grouping."""
    samples = bench_nmt.synthetic_samples(64 * 200, 40, 30000, seed=1)
    key = lambda s: len(s[0]) + len(s[1])     # noqa: E731
    pooled = list(jdec.pool_batch_by_length(
        lambda: iter(samples), 64, pool_factor=16, key=key,
        shuffle_batches=False, drop_last=True)())
    groups = {}
    for b in pooled:
        sp = jdec.snap_length(max(len(s[0]) for s in b), 8)
        tp = jdec.snap_length(max(len(s[1]) for s in b), 8)
        groups.setdefault((sp, tp), []).append(b)
    want = []
    for (sp, tp), bs in sorted(groups.items()):
        feed = bench_nmt.make_feed(bs[0], max_len=None, pad_to_multiple=8)
        want.append((feed, len(bs)) + bench_nmt._feed_tokens(feed))
    got, batches = nmt.pooled_schedule(samples, 64, 16, 8)
    assert len(batches) == len(pooled) == 200
    assert [(n, s, t) for _, n, s, t in got] == \
        [(n, s, t) for _, n, s, t in want]
    for (fa, *_), (fb, *_) in zip(got, want):
        for k in fa:
            np.testing.assert_array_equal(fa[k].data, fb[k].data)
    assert len(got) >= 2


# -- run_steps across padded shapes -------------------------------------------

def test_run_steps_equals_run_across_two_padded_shapes():
    prog, startup, loss, _ = port_build(amp=False)
    pairs = nmt.synthetic_samples(2 * BATCH, SEQ, V, seed=2)
    f1 = nmt.make_feed(pairs[:BATCH], pad_to_multiple=4)
    f2 = nmt.make_feed(pairs[BATCH:], max_len=SEQ + 4)
    assert f1["src_word_id"].max_len != f2["src_word_id"].max_len
    schedule = [(f1, 2), (f2, 3), (f1, 2)]
    base = pfluid.Scope()
    exe = pfluid.Executor(pfluid.CPUPlace())
    exe.run(startup, scope=base)
    state = {n: v.clone() for n, v in base.vars.items()}

    def fresh():
        s = pfluid.Scope()
        for n, v in state.items():
            s.set_var(n, v.clone())
        return s

    ref = fresh()
    ref_exe = pfluid.Executor(pfluid.CPUPlace())
    ref_losses = []
    for feed, n in schedule:
        for _ in range(n):
            ref_losses.append(ref_exe.run(prog, feed=feed,
                                          fetch_list=[loss], scope=ref)[0])
    got = fresh()
    exe = pfluid.Executor(pfluid.CPUPlace())
    pprofiler.reset_counters()
    losses = []
    for feed, n in schedule:
        h = exe.run_steps(prog, feed=feed, n_steps=n, fetch_list=[loss],
                          scope=got, return_numpy=False)
        losses.append(h.numpy()[0])
    tel = psteps.step_summary()
    np.testing.assert_array_equal(np.array(losses),
                                  np.array([ref_losses[i]
                                            for i in (1, 4, 6)]))
    differ = [n for n in state
              if not torch.equal(got.find_var(n), ref.find_var(n))]
    assert not differ, differ
    assert tel["compile_cache_misses_by_cause"] == {
        "first_compile": 1.0, "feed_signature": 1.0}
    assert tel["compile_cache_hits"] == 1.0
    assert tel["steps"] == 7.0
    # the real and padding tokens of the host ragged feeds, once a call
    counters = pprofiler.get_counters()
    assert counters["real_tokens"] == sum(
        int(np.sum(f[k].length)) for f, _ in schedule for k in f)
    assert counters["pad_tokens"] == sum(
        f[k].data.size - int(np.sum(f[k].length))
        for f, _ in schedule for k in f)


# -- the bench's main ---------------------------------------------------------

def _bench_nmt_keys():
    """The keys of the JSON line bench_nmt.py's main prints."""
    tree = ast.parse(open(bench_nmt.__file__).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            return [k.value for k in node.keys]
    raise AssertionError("no JSON dict in bench_nmt.main")


def test_bench_main_tiny_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_FORCE_CPU", "1")
    for k, v in {"BATCH": 4, "SEQ": 12, "ITERS": 4, "ROUNDS": 2,
                 "WARMUP": 2, "SRC_VOCAB": V, "TRG_VOCAB": V,
                 "POOL_FACTOR": 2, "POOL_BUCKET": 4, "EMB": W,
                 "HID": W}.items():
        monkeypatch.setattr(nmt, k, v)
    with punique.guard():
        rec = nmt.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == _bench_nmt_keys()
    assert line["metric"] == bench_nmt.METRIC and line["unit"] == "tokens/sec"
    assert line["value"] > 0 and line["mfu"] is None
    assert line["distinct_padded_shapes"] == len(rec["_shapes"]) >= 1
    assert line["pooled_steps"] == 4
    assert line["pooled_compile_cache_misses"] == 0
    assert len(rec["_sweep_s"]["pooled"]) == 2
    losses = [float(h.numpy()[0]) for h in rec["_handles"]["baseline"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_captures_of_a_program_share_static_state(monkeypatch):
    """The captured steps of one program (one a padded shape) share their
    static state tensors, so a switch of shapes copies nothing, and a
    new capture loads what a ``run()`` put in the scope. The capture
    itself needs the card; its setup runs here."""
    from paddle_tpu_torch import executor as pexecutor
    prog, startup, loss, _ = port_build(amp=False)
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    exe.run(startup, scope=scope)
    monkeypatch.setattr(pexecutor._CapturedStep, "_capture",
                        lambda self, start: None)
    pairs = nmt.synthetic_samples(2 * BATCH, SEQ, V, seed=2)
    feeds = [exe._convert_feed(prog, nmt.make_feed(p, max_len=m))
             for p, m in ((pairs[:BATCH], SEQ), (pairs[BATCH:], SEQ + 4))]
    a = pexecutor._CapturedStep(exe, prog, scope, feeds[0], [loss.name], 0)
    for n, t in a.state.items():     # as run_steps leaves the scope
        scope.set_var(n, t)
    b = pexecutor._CapturedStep(exe, prog, scope, feeds[1], [loss.name], 0)
    assert set(b.state) == set(a.state) and len(a.state) > 40
    assert all(b.state[n] is a.state[n] for n in a.state)
    assert b.feed["src_word_id"].data.shape == (BATCH, SEQ + 4)
    new = torch.randn_like(a.state["fc_0.w_0"])
    scope.set_var("fc_0.w_0", new)   # a run() replaced it
    c = pexecutor._CapturedStep(exe, prog, scope, feeds[0], [], 0)
    assert c.state["fc_0.w_0"] is a.state["fc_0.w_0"]
    assert torch.equal(a.state["fc_0.w_0"], new)
    exe.close()
    assert exe._static == {} and exe._pools == {}
