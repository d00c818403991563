"""The port's attention ops against the JAX reference on the CPU: the
plain version of the paged-decode kernel (K3) against the reference's
XLA gather lowering and against its Pallas kernel in interpret mode,
across the head_dim × page_size × GQA grid; the plain prefill/recompute
attention ops against theirs; and the K3 wrapper's CPU/non-CUDA rules.
The CUDA kernel itself is held against the same plain version on the
card by chip_smoke.py."""

import functools

import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_paged_attention as ppa
from paddle_tpu.ops.attention_ops import (decode_paged_attention,
                                          dot_product_attention,
                                          paged_chunk_attention)
from paddle_tpu_torch import _build
from paddle_tpu_torch.ops import attention as port_att
from paddle_tpu_torch.ops import paged_attention as port_k3

# (heads, kv_heads, head_dim, page): the reference's unit geometry, then
# its on-chip tuning grid (tests/serving/test_paged_generation.py)
GRID = [(2, 2, 8, 4), (4, 4, 32, 8), (4, 2, 64, 16), (8, 2, 128, 16),
        (4, 2, 192, 8), (4, 1, 256, 8)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pool_case(geom, seed=6, S=4, MP=6):
    H, HKV, D, page = geom
    rng = np.random.RandomState(seed)
    P = S * MP
    k_pool = rng.randn(P + 1, page, HKV, D).astype(np.float32)
    v_pool = rng.randn(P + 1, page, HKV, D).astype(np.float32)
    pt = rng.randint(0, P, size=(S, MP)).astype(np.int32)
    q = rng.randn(S, H, D).astype(np.float32)
    # 0 (clamped to one live position), one token, a mid-page frontier,
    # the full window
    lengths = np.array([0, 1, 2 * page + 3, MP * page], np.int32)
    return q, k_pool, v_pool, pt, lengths


def _port_k3(q, k_pool, v_pool, pt, lengths):
    return port_k3.paged_decode_attention(
        _t(q), _t(k_pool), _t(v_pool), _t(pt), _t(lengths)).numpy()


@pytest.mark.parametrize("geom", GRID)
def test_plain_k3_matches_reference_gather_lowering(geom):
    args = _pool_case(geom)
    ref = np.asarray(decode_paged_attention(*args))
    np.testing.assert_allclose(_port_k3(*args), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("geom", GRID)
def test_plain_k3_matches_reference_pallas_kernel(monkeypatch, geom):
    """The Pallas TPU kernel the CUDA kernel replaces, run in interpret
    mode as the reference's own tests run it on the CPU."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    args = _pool_case(geom, seed=7)
    ref = np.asarray(ppa.paged_flash_decode(*args))
    np.testing.assert_allclose(_port_k3(*args), ref, rtol=1e-4, atol=1e-5)


def test_plain_k3_ignores_table_entries_past_the_frontier():
    q, k_pool, v_pool, pt, lengths = _pool_case((2, 2, 8, 4))
    lengths = np.array([5, 9, 1, 4], np.int32)   # 2, 3, 1, 1 live pages
    base = _port_k3(q, k_pool, v_pool, pt, lengths)
    pt2 = pt.copy()
    pt2[:, 3:] = 0
    np.testing.assert_array_equal(
        base, _port_k3(q, k_pool, v_pool, pt2, lengths))


def test_decode_paged_attention_bf16_is_cast_once_from_fp32():
    """bf16 inputs: logits, softmax and the weighted sum run in fp32 and
    the output is rounded once — the kernel's arithmetic."""
    q, k_pool, v_pool, pt, lengths = _pool_case((4, 2, 64, 16))
    qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, k_pool, v_pool))
    got = port_k3.paged_decode_attention(qb, kb, vb, _t(pt), _t(lengths))
    assert got.dtype == torch.bfloat16
    ref = port_k3.paged_decode_attention_plain(
        qb.float(), kb.float(), vb.float(), _t(pt), _t(lengths))
    torch.testing.assert_close(got, ref.to(torch.bfloat16), rtol=0, atol=0)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    args = [_t(a) for a in _pool_case((4, 2, 64, 16))]
    before = port_k3.launches
    got = port_k3.paged_decode_attention(*args)
    assert port_k3.launches == before
    torch.testing.assert_close(
        got, port_k3.paged_decode_attention_plain(*args), rtol=0, atol=0)


def test_wrapper_raises_instead_of_falling_back():
    q, k_pool, v_pool, pt, lengths = (_t(a) for a in
                                      _pool_case((4, 2, 64, 16)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        port_k3.paged_decode_attention(
            *(t.to("meta") for t in (q, k_pool, v_pool, pt, lengths)))
    with pytest.raises(ValueError, match="span devices"):
        port_k3.paged_decode_attention(q.to("meta"), k_pool, v_pool, pt,
                                       lengths)
    with pytest.raises(ValueError, match="not divisible"):
        port_k3.paged_decode_attention(q[:, :3], k_pool, v_pool, pt,
                                       lengths)
    with pytest.raises(ValueError, match="differ in shape"):
        port_k3.paged_decode_attention(q, k_pool, v_pool[:-1], pt, lengths)


@pytest.mark.parametrize("gqa", [False, True])
def test_paged_chunk_attention_matches_reference(gqa):
    rng = np.random.RandomState(1)
    H, HKV = (4, 2) if gqa else (2, 2)
    k_pool = rng.randn(13, 4, HKV, 8).astype(np.float32)
    v_pool = rng.randn(13, 4, HKV, 8).astype(np.float32)
    pt = rng.randint(0, 12, size=(3, 5)).astype(np.int32)
    base = np.array([4, 9, 0], np.int32)
    q = rng.randn(3, 3, H, 8).astype(np.float32)
    ref = np.asarray(paged_chunk_attention(q, k_pool, v_pool, pt, base))
    got = port_att.paged_chunk_attention(_t(q), _t(k_pool), _t(v_pool),
                                         _t(pt), _t(base)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout,hkv,sq,sk", [
    ("bshd", 4, 6, 6), ("bshd", 2, 3, 7), ("bhsd", 4, 5, 5),
    ("bhsd", 1, 2, 6)])
def test_causal_dot_product_attention_matches_reference(layout, hkv, sq,
                                                        sk):
    rng = np.random.RandomState(2)
    if layout == "bshd":
        q = rng.randn(2, sq, 4, 8).astype(np.float32)
        k = rng.randn(2, sk, hkv, 8).astype(np.float32)
        v = rng.randn(2, sk, hkv, 8).astype(np.float32)
    else:
        q = rng.randn(2, 4, sq, 8).astype(np.float32)
        k = rng.randn(2, hkv, sk, 8).astype(np.float32)
        v = rng.randn(2, hkv, sk, 8).astype(np.float32)
    ref = np.asarray(dot_product_attention(q, k, v, causal=True,
                                           layout=layout))
    got = port_att.dot_product_attention(_t(q), _t(k), _t(v), causal=True,
                                         layout=layout).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_kernel_build_targets_sm90a_from_the_repo_sources(tmp_path):
    """The build compiles only the package's own CUDA sources, for
    sm_90a, into the git-ignored build directory, keyed by content."""
    cmd = _build.nvcc_command("paged_decode", str(tmp_path / "k.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == _build.CSRC_DIR + "/paged_decode.cu"
    path = _build.library_path("paged_decode")
    assert path.startswith(_build.BUILD_DIR + "/")
    assert path == _build.library_path("paged_decode")
    with open(cmd[-1]) as f:
        src = f.read()
    assert "pallas_paged_attention.py::paged_flash_decode" in src
    with pytest.raises(KeyError):
        _build.library_path("no_such_kernel")
