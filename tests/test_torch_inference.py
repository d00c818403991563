"""Inference deployment in the port against the JAX package on the CPU.

Tiny models: the stacked-LSTM classifier (dict 50, emb 8, hid 16,
sequences up to 12 ids), ``resnet_cifar10(depth=8)`` on 32x32 images (its
last pool is 8x8: the smallest input it takes) and the transformer LM
(2 layers, d_model 32, 2 heads, vocab 97, 16 tokens). Weights are the
JAX startup's, carried over by name.

- ``Program.to_dict``: the port's dict equals the reference's, and
  each package runs the other's dict to its own program's outputs
  (bitwise).
- ``clone(for_test=True)`` and ``prune`` give the reference's dicts.
- ``save_inference_model`` directories cross both ways: the port
  loads and runs the reference's within 1e-5 of the reference's own
  ``load_inference_model`` + run, and the reference the port's.
- ``export_artifact`` → ``load_artifact`` → ``run`` against
  ``export_stablehlo`` → ``load_stablehlo`` → ``run`` (1e-5 relative)
  at batches other than the export's (the batch dim symbolic), with a
  ragged feed; its errors (an overlong sequence, a missing feed, a bad
  directory, bad metadata, ``native_batch``) name what is wrong.
- A fresh process runs an artifact without model code or JAX.
- The LM's artifact records K1 as the ``paddle_tpu::flash_fwd`` custom
  op and equals ``Executor.run``; a program reaching a kernel without a
  custom op (the flash backward) refuses to export, naming the kernel.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import models as jmodels  # noqa: F401  (jfluid.models)
from paddle_tpu import unique_name as junique
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import unique_name as punique
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.executor import Scope as PScope
from paddle_tpu_torch.executor import scope_guard as pscope_guard

DICT, EMB, HID, MAXLEN = 50, 8, 16, 12
VOCAB, SEQ = 97, 16
TOL = dict(rtol=1e-5, atol=1e-6)


def build(pkg, model, train=False, amp=False):
    """(main, startup, prediction, feed names) of ``model`` in ``pkg``
    (``jfluid`` or ``pfluid``); ``train`` adds a loss and an optimizer."""
    un = junique if pkg is jfluid else punique
    with un.guard():
        prog, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(prog, startup):
            L = pkg.layers
            if model == "lstm":
                x = L.data(name="words", shape=[1], dtype="int64",
                           lod_level=1)
                pred = pkg.models.stacked_lstm_net(x, DICT, emb_dim=EMB,
                                                   hid_dim=HID)
            elif model == "resnet":
                x = L.data(name="img", shape=[3, 32, 32], dtype="float32")
                pred = pkg.models.resnet_cifar10(x, class_dim=10, depth=8)
            else:
                x = L.data(name="ids", shape=[SEQ], dtype="int64")
                pred = pkg.models.transformer_lm(
                    x, VOCAB, num_layers=2, d_model=32, num_heads=2,
                    max_len=SEQ)
            if train:
                label = L.data(name="label", shape=[1], dtype="int64")
                loss = L.mean(L.cross_entropy(pred, label))
                pkg.optimizer.Adam(1e-3).minimize(loss)
        if amp:
            pkg.enable_mixed_precision(prog)
    return prog, startup, pred, [x.name]


def jax_state(startup):
    scope = JScope()
    with jscope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return scope, {n: np.asarray(v) for n, v in scope.vars.items()
                   if v is not None}


def feed_of(model, batch, seed=0):
    rng = np.random.RandomState(seed)
    if model == "lstm":
        return {"words": [rng.randint(0, DICT, size=n).astype(np.int64)
                          for n in rng.randint(1, MAXLEN + 1, size=batch)]}
    if model == "resnet":
        return {"img": rng.rand(batch, 3, 32, 32).astype(np.float32)}
    return {"ids": rng.randint(0, VOCAB, size=(batch, SEQ)).astype(np.int64)}


def normalized(d):
    return json.loads(json.dumps(d, default=str, sort_keys=True))


@pytest.mark.parametrize("model", ["lstm", "resnet", "lm"])
def test_program_dict_round_trips_with_the_reference(model):
    jp, js, jpred, _ = build(jfluid, model)
    pp, _, ppred, _ = build(pfluid, model)
    jd, pd = normalized(jp.to_dict()), normalized(pp.to_dict())
    assert pd == jd
    jscope, state = jax_state(js)
    feed = feed_of(model, 3)
    jtest = jp.clone(for_test=True)
    with jscope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        jref = exe.run(jtest, feed=feed, fetch_list=[jpred.name])[0]
        jgot = exe.run(jfluid.Program.from_dict(
            normalized(pp.clone(for_test=True).to_dict())), feed=feed,
            fetch_list=[jpred.name])[0]
    np.testing.assert_array_equal(jgot, jref)
    scope = scope_from_jax(state, device="cpu")
    pexe = pfluid.Executor(pfluid.CPUPlace())
    pref = pexe.run(pp.clone(for_test=True), feed=feed,
                    fetch_list=[ppred.name], scope=scope)[0]
    pgot = pexe.run(pfluid.Program.from_dict(normalized(jtest.to_dict())),
                    feed=feed, fetch_list=[ppred.name], scope=scope)[0]
    np.testing.assert_array_equal(pgot, pref)
    np.testing.assert_allclose(pref, jref, **TOL)


def test_program_dict_keeps_op_uids_amp_and_parallelism_records():
    pp, _, _, _ = build(pfluid, "lstm", amp=True)
    d = pp.to_dict()
    d["accumulator_owner"] = {"moment1_0": 1}
    d["sharding_plan"] = {"w": {"param": {"P": [None, "tp"]}}}
    d["blocks"][0]["vars"][0]["sharding"] = {"P": ["dp"]}
    q = pfluid.Program.from_dict(normalized(d))
    assert q._amp and q.to_dict()["sharding_plan"] == d["sharding_plan"]
    assert q.to_dict()["accumulator_owner"] == {"moment1_0": 1}
    assert [op.op_uid for op in q.global_block().ops] == \
        [op.op_uid for op in pp.global_block().ops]
    assert q._op_uid_counter == pp._op_uid_counter
    # the reference reads it, parallelism records included
    r = jfluid.Program.from_dict(normalized(q.to_dict()))
    assert r._amp and r._accumulator_owner == {"moment1_0": 1}


def port_view(program):
    """The reference's dict as the port writes it: the reference's
    optimizer records ``accumulator_owner`` (a parallelism record the
    port keeps when it reads one, and does not write)."""
    d = normalized(program.to_dict())
    d.pop("accumulator_owner", None)
    return d


@pytest.mark.parametrize("model", ["lstm", "resnet"])
def test_clone_for_test_and_prune_match_the_reference(model):
    jp, _, jpred, _ = build(jfluid, model, train=True)
    pp, _, ppred, _ = build(pfluid, model, train=True)
    jc, pc = jp.clone(for_test=True), pp.clone(for_test=True)
    assert pc._is_test and normalized(pc.to_dict()) == port_view(jc)
    jr, pr = jp.prune([jpred]), pp.prune([ppred])
    assert [op.type for op in pr.global_block().ops] == \
        [op.type for op in jr.global_block().ops]
    assert normalized(pr.to_dict()) == port_view(jr)
    assert normalized(pp.prune([ppred]).inference_optimize().to_dict()) == \
        port_view(jp.prune([jpred]).inference_optimize())
    if model == "resnet":
        assert any(op.attr("is_test") for op in pc.global_block().ops
                   if op.type == "batch_norm")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_inference_model_directories_cross_packages(writer, tmp_path):
    jp, js, jpred, feeds = build(jfluid, "lstm")
    pp, _, ppred, _ = build(pfluid, "lstm")
    jscope, state = jax_state(js)
    d = str(tmp_path / "model")
    feed = feed_of("lstm", 4, seed=1)
    if writer == "reference":
        with jscope_guard(jscope):
            jfluid.io.save_inference_model(
                d, feeds, [jpred], jfluid.Executor(jfluid.CPUPlace()),
                main_program=jp)
    else:
        scope = scope_from_jax(state, device="cpu")
        with pscope_guard(scope):
            pfluid.io.save_inference_model(
                d, feeds, [ppred], pfluid.Executor(pfluid.CPUPlace()),
                main_program=pp)
    with jscope_guard(JScope()):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jprog, jfeeds, jfetch = jfluid.io.load_inference_model(d, jexe)
        jout = jexe.run(jprog, feed=feed, fetch_list=jfetch)[0]
    with pscope_guard(PScope()):
        pexe = pfluid.Executor(pfluid.CPUPlace())
        prog, pfeeds, pfetch = pfluid.io.load_inference_model(d, pexe)
        pout = pexe.run(prog, feed=feed, fetch_list=pfetch)[0]
    assert pfeeds == jfeeds == feeds and prog._is_test
    assert [v.name for v in pfetch] == [v.name for v in jfetch]
    np.testing.assert_allclose(pout, jout, **TOL)


def export_both(model, tmp_path, amp=False):
    """The same program exported by both packages from one state: (port
    artifact, reference artifact, port program, its prediction)."""
    jp, js, jpred, feeds = build(jfluid, model, amp=amp)
    pp, _, ppred, _ = build(pfluid, model, amp=amp)
    jscope, state = jax_state(js)
    maxlen = MAXLEN if model == "lstm" else None
    with jscope_guard(jscope):
        jfluid.io.export_stablehlo(
            str(tmp_path / "jax"), feeds, [jpred],
            jfluid.Executor(jfluid.CPUPlace()), main_program=jp,
            max_seq_len=maxlen)
    scope = scope_from_jax(state, device="cpu")
    pexe = pfluid.Executor(pfluid.CPUPlace())
    names = pfluid.io.export_artifact(
        str(tmp_path / "port"), feeds, [ppred], pexe, main_program=pp,
        scope=scope, max_seq_len=maxlen)
    assert names == [ppred.name]
    return (pfluid.io.load_artifact(str(tmp_path / "port")),
            jfluid.io.load_stablehlo(str(tmp_path / "jax")), pp, ppred,
            scope)


@pytest.fixture(scope="module")
def lstm_export(tmp_path_factory):
    """The classifier exported by both packages, once for the module."""
    d = tmp_path_factory.mktemp("lstm")
    return d, export_both("lstm", d)


@pytest.mark.parametrize("model", ["lstm", "resnet"])
def test_exported_artifact_matches_the_reference_artifact(
        model, tmp_path, lstm_export):
    if model == "lstm":
        tmp_path, (art, ref, _, _, _) = lstm_export
    else:
        art, ref, _, _, _ = export_both(model, tmp_path)
    meta = json.load(open(tmp_path / "port" / "__export_meta__.json"))
    jmeta = json.load(open(tmp_path / "jax" / "__export_meta__.json"))
    assert meta["feeds"] == jmeta["feeds"]
    assert meta["fetch_var_names"] == jmeta["fetch_var_names"]
    assert meta["max_seq_len"] == jmeta["max_seq_len"]
    for batch in (1, 3, 5):                  # exported at 4
        feed = feed_of(model, batch, seed=batch)
        got, want = art.run(feed)[0], ref.run(feed)[0]
        assert got.shape == want.shape == (batch, 2 if model == "lstm"
                                           else 10)
        np.testing.assert_allclose(got, want, **TOL)


def test_artifact_errors_name_what_is_wrong(tmp_path, lstm_export):
    pp, _, ppred, feeds = build(pfluid, "lstm")
    exe = pfluid.Executor(pfluid.CPUPlace())
    d = str(tmp_path / "art")
    with pytest.raises(ValueError, match="'words' is a LoD sequence"):
        pfluid.io.export_artifact(d, feeds, [ppred], exe, main_program=pp)
    with pytest.raises(NotImplementedError, match="native_batch"):
        pfluid.io.export_artifact(d, feeds, [ppred], exe, main_program=pp,
                                  max_seq_len=MAXLEN, native_batch=8)
    art = lstm_export[1][0]
    with pytest.raises(ValueError, match="feed 'words': sequence length 13 "
                                         "exceeds .* max_seq_len=12"):
        art.run({"words": [np.arange(MAXLEN + 1)]})
    with pytest.raises(KeyError, match="missing feed 'words'"):
        art.run({"ids": [np.arange(3)]})
    with pytest.raises(ValueError, match="is not a directory"):
        pfluid.io.load_artifact(str(tmp_path / "nowhere"))
    with pytest.raises(ValueError, match="missing __model__.pt2"):
        pfluid.io.load_artifact(str(tmp_path))
    shutil.copytree(str(lstm_export[0] / "port"), d, dirs_exist_ok=True)
    meta_path = os.path.join(d, "__export_meta__.json")
    meta = json.load(open(meta_path))
    meta["feeds"][0]["shape"] = [None, None]
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(ValueError, match="feed 'words' has 2 polymorphic"):
        pfluid.io.load_artifact(d)


def test_artifact_runs_in_a_fresh_process_without_model_code(
        tmp_path, lstm_export):
    art = lstm_export[1][0]
    feed = feed_of("lstm", 3, seed=2)
    np.savez(str(tmp_path / "in.npz"), *feed["words"])
    script = (
        "import sys, numpy as np\n"
        "from paddle_tpu_torch.inference_export import load_artifact\n"
        "seqs = list(np.load('in.npz').values())\n"
        "out = load_artifact(sys.argv[1]).run({'words': seqs})[0]\n"
        "np.save('out.npy', out)\n"
        "bad = [m for m in sys.modules if m == 'jax' or\n"
        "       m.startswith(('paddle_tpu_torch.models', 'paddle_tpu.'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    subprocess.run([sys.executable, "-c", script,
                    str(lstm_export[0] / "port")], cwd=str(tmp_path),
                   env=env, check=True, timeout=120)
    np.testing.assert_array_equal(np.load(str(tmp_path / "out.npy")),
                                  art.run(feed)[0])


def test_lm_artifact_records_the_flash_kernel_as_a_custom_op(tmp_path):
    art, ref, pp, ppred, scope = export_both("lm", tmp_path, amp=True)
    ops = [str(n.target) for n in art.graph.nodes
           if n.op == "call_function"]
    assert ops.count("paddle_tpu.flash_fwd.default") == 2
    exe = pfluid.Executor(pfluid.CPUPlace())
    for batch in (1, 3):
        feed = feed_of("lm", batch, seed=batch)
        got = art.run(feed)[0]
        want = exe.run(pp.clone(for_test=True), feed=feed,
                       fetch_list=[ppred.name], scope=scope)[0]
        np.testing.assert_array_equal(got, want)
        # bf16 against the reference's XLA roundings
        np.testing.assert_allclose(got, ref.run(feed)[0], rtol=0.05,
                                   atol=0.05)


def test_export_refuses_a_kernel_without_a_custom_op(tmp_path):
    with punique.guard():
        prog, startup = pfluid.Program(), pfluid.Program()
        with pfluid.program_guard(prog, startup):
            ids = pfluid.layers.data(name="ids", shape=[SEQ], dtype="int64")
            logits = pfluid.models.transformer_lm(
                ids, VOCAB, num_layers=1, d_model=32, num_heads=2,
                max_len=SEQ)
            loss = pfluid.layers.mean(logits)
            pfluid.append_backward(loss)
    grad = next(n for op in prog.global_block().ops
                if op.type == "fused_attention_grad"
                for n in op.output("Q@GRAD"))
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = PScope()
    with pscope_guard(scope):
        exe.run(startup)
        with pytest.raises(NotImplementedError,
                           match="kernel K2 / K6 .* has no custom op"):
            pfluid.io.export_artifact(str(tmp_path / "art"), ["ids"],
                                      [grad], exe, main_program=prog)
