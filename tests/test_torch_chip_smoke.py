"""A CPU rehearsal of ``chip_smoke.py``'s training phases at a tiny size:
the flash kernel checks, the fp32 card-vs-CPU gate, the training run and
the kernel timing report, with every tensor on the CPU.

CPU tensors take the kernels' plain versions and count no launch, and
K2-dQ / K2-dKV exist only on CUDA, so the rehearsal swaps in shims that
compute through the plain versions and count one launch each. CUDA
events are stubbed (a fixed 0.5 ms). What it shows: the phases' control
flow, shapes, launch accounting and report keys hold together; it
cannot show that a kernel compiles or how fast anything runs.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu_torch as fluid
from paddle_tpu_torch.ops import flash_attention as fa

ROW_KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


@pytest.fixture
def tiny(monkeypatch):
    for name, value in (("DEVICE", "cpu"), ("LM_VOCAB", 97), ("LM_DIM", 32),
                        ("LM_HEADS", 2), ("LM_LAYERS", 2), ("LM_BATCH", 2),
                        ("LM_SEQ", 64), ("LM_STEPS", 3), ("LM_LR", 1e-2),
                        ("LM_PROFILE_STEPS", 1), ("GATE_BATCH", 2),
                        ("GATE_SEQ", 32),
                        ("FLASH_GEOMS", [(3, 64, 4, 4, 16),
                                         (3, 50, 4, 2, 16)])):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "_timed", lambda fn, args, reps, flush:
                        (fn(*args), 0.5)[1])
    monkeypatch.setattr(fluid, "CUDAPlace", lambda i=0: fluid.CPUPlace())
    real_fwd = fa.flash_fwd

    def fwd(*a, **k):
        fa.launches["flash_fwd"] += 1
        return real_fwd(*a, **k)

    def grads(q, k, v, do, lse, scale, causal, k_valid):
        o = fa.flash_fwd_plain(q, k, v, scale, causal, k_valid)[0]
        return fa.flash_bwd_plain(q, k, v, o, lse, do, scale, causal,
                                  k_valid)

    def dq(q, k, v, do, lse, delta, scale=None, causal=False, k_valid=None):
        fa.launches["flash_bwd_dq"] += 1
        return grads(q, k, v, do, lse, scale, causal, k_valid)[0]

    def dkv(q, k, v, do, lse, delta, scale=None, causal=False, k_valid=None):
        fa.launches["flash_bwd_dkv"] += 1
        return grads(q, k, v, do, lse, scale, causal, k_valid)[1:]

    def bwd(q, k, v, o, lse, do, scale=None, causal=False, k_valid=None):
        delta = (do.float() * o.float()).sum(-1)
        return (fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal,
                                k_valid),) + \
            fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, k_valid)

    for name, fn in (("flash_fwd", fwd), ("flash_bwd_dq", dq),
                     ("flash_bwd_dkv", dkv), ("flash_bwd", bwd)):
        monkeypatch.setattr(fa, name, fn)
    saved = dict(fa.launches)
    yield
    fa.launches.update(saved)


def test_training_phases_rehearse_on_the_cpu(tiny, capsys):
    before = dict(fa.launches)
    rows = cs.flash_checks()
    assert len(rows) == 2 * 8 + 1 and all(r["ok"] for r in rows)
    assert fa.launches == before     # comparison launches are restored
    gate = cs.train_gate()
    assert gate["loss_rel_err"] <= cs.GATE_LOSS_RTOL
    res = cs.train_path()
    steps_x_layers = cs.LM_STEPS * cs.LM_LAYERS
    assert res["launches"] == {n: steps_x_layers for n in fa.launches}
    assert res["losses"][-1] < res["losses"][0]
    assert {"mul", "mul_grad", "fused_attention",
            "fused_attention_grad", "adam"} <= set(res["ops"])
    assert res["ops"]["fused_attention"]["calls"] == cs.LM_LAYERS
    timing = cs.flash_timing(res["launches"])
    assert [r["name"] for r in timing] == list(fa.launches)
    for row in timing:
        assert ROW_KEYS <= set(row) and row["launches"] == steps_x_layers
        assert row["bound_by"] in ("bytes", "operations")
    json.dumps(timing)
    assert "flash_fwd" in capsys.readouterr().out


def test_smoke_exits_nonzero_without_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main([]) != 0
    assert capsys.readouterr().out == ""


def test_flash_case_zeroes_the_cotangent_of_padded_rows(monkeypatch):
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    q, k, v, do, valid = cs._flash_case(np.random.RandomState(0), 3, 40, 2,
                                        1, 8, torch.float32, True)
    assert valid[0].all() and not valid[2].any()
    assert valid[1, :30].all() and not valid[1, 30:].any()
    assert not do[2].any() and not do[1, 30:].any() and do[0].all()
