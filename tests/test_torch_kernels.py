"""Port kernels (`repro_torch.kernels`) against the JAX package: each
kernel's plain-torch version against the Pallas TPU kernel run in interpret
mode and against the JAX oracle (`kernels/*/ref.py`), on the same inputs
made with numpy.  Tolerances are `tests/test_kernels.py`'s: 1e-5 for kNN
scores, 2e-5 for f32 attention, 5e-2 for bf16.  The CUDA kernels
themselves run only on a GPU: `test_torch_gpu.py` holds each against its
plain version there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_reference  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.knn_ivf.ops import ivf_scan, ivfpq_adc  # noqa: E402
from repro_torch.kernels.knn_topk.ops import knn_topk  # noqa: E402


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _knn_data(Q, N, D, seed):
    rng = np.random.default_rng(seed)
    return (_unit(rng.normal(size=(Q, D))),
            rng.normal(size=(N, D)).astype(np.float32))


# ---------------------------------------------------------------------------
# knn_topk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Q,N,D,k", [
    (8, 64, 32, 5), (130, 1000, 64, 100), (4, 50, 16, 7), (16, 256, 128, 32),
    (3, 1030, 24, 17),
])
def test_knn_plain_matches_pallas_and_reference(Q, N, D, k):
    from repro.kernels.knn_topk.ops import knn_topk as jax_knn
    from repro.kernels.knn_topk.ref import knn_topk_reference as jax_ref
    q, s = _knn_data(Q, N, D, Q * N + k)
    ts, ti = knn_topk(torch.from_numpy(q), torch.from_numpy(s), k)
    assert ts.shape == (Q, k) and ti.dtype == torch.int32
    for js, ji in (jax_knn(q, s, k, use_pallas=True, interpret=True),
                   jax_ref(jnp.asarray(q), jnp.asarray(s), k)):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                                   rtol=1e-5, atol=1e-5)
        # no exact ties in gaussian data: the neighbour sets agree
        assert all(set(a) == set(b) for a, b in zip(ti.numpy(),
                                                    np.asarray(ji)))


def test_knn_k_above_n_fills_tail_with_empty_slots():
    """k > N: the first N slots hold every row, sorted; the tail is -1/-inf,
    as the Pallas kernel's merge_topk emits -1 (with its NEG sentinel)."""
    from repro.kernels.knn_topk.kernel import NEG, knn_topk_pallas
    q, s = _knn_data(8, 64, 32, 3)
    ts, ti = knn_topk(torch.from_numpy(q), torch.from_numpy(s), 100)
    ps, pi = knn_topk_pallas(jnp.asarray(q), jnp.asarray(s), 100)
    ps, pi = np.asarray(ps), np.asarray(pi)
    assert (pi[:, 64:] == -1).all() and (ps[:, 64:] == NEG).all()
    assert (ti.numpy()[:, 64:] == -1).all()
    assert np.isneginf(ts.numpy()[:, 64:]).all()
    np.testing.assert_allclose(ts.numpy()[:, :64], ps[:, :64],
                               rtol=1e-5, atol=1e-5)
    assert all(set(row) == set(range(64)) for row in ti.numpy()[:, :64])


def test_knn_duplicate_rows_tied_scores():
    """Duplicated support rows tie exactly: scores match and tied ids
    point at copies of the same row (compared as sets)."""
    from repro.kernels.knn_topk.ops import knn_topk as jax_knn
    rng = np.random.default_rng(9)
    base = rng.normal(size=(40, 16)).astype(np.float32)
    s = np.concatenate([base, base])
    q = _unit(rng.normal(size=(6, 16)))
    ts, ti = knn_topk(torch.from_numpy(q), torch.from_numpy(s), 10)
    js, ji = jax_knn(q, s, 10, use_pallas=True, interpret=True)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    assert all(set(a % 40) == set(b % 40)
               for a, b in zip(ti.numpy(), np.asarray(ji)))


def test_knn_bf16_support_matches_jax_reference():
    from repro.kernels.knn_topk.ref import knn_topk_reference as jax_ref
    q, s = _knn_data(16, 128, 64, 5)
    sb = torch.from_numpy(s).to(torch.bfloat16)
    ts, _ = knn_topk(torch.from_numpy(q), sb, 8)
    js, _ = jax_ref(jnp.asarray(q), jnp.asarray(s, jnp.bfloat16), 8)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-2,
                               atol=2e-2)


def test_knn_wrapper_takes_any_k_at_least_one():
    """No k above 0 is refused: the kernel path selects k > 1,024 in rounds
    of 1,024 (the keyed selection above 128), so a device tensor with
    k = 1,025 reaches the device check, and the plain version on the CPU
    takes any k, as the reference does.  Only k < 1 is refused."""
    from repro.kernels.knn_topk.ref import knn_topk_reference as jax_ref
    q, s = _knn_data(2, 3000, 8, 0)
    for k in (129, 1024, 2000):
        ts, ti = knn_topk(torch.from_numpy(q), torch.from_numpy(s), k)
        js, ji = jax_ref(jnp.asarray(q), jnp.asarray(s), k)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
        assert ts.shape == ti.shape == (2, k)
    with pytest.raises(ValueError, match="unsupported device"):
        knn_topk(torch.from_numpy(q).to("meta"),
                 torch.from_numpy(s).to("meta"), 1025)
    with pytest.raises(ValueError, match="k >= 1"):
        knn_topk(torch.from_numpy(q), torch.from_numpy(s), 0)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _attn_data(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", [
    (2, 128, 4, 2, 64, True, 0),
    (1, 64, 12, 12, 64, True, 0),        # the query encoder's shape
    (2, 128, 4, 1, 64, True, 64),
    (1, 64, 2, 2, 16, False, 0),
    (1, 256, 4, 2, 80, True, 100),        # danube's head_dim, ragged window
])
def test_flash_plain_matches_pallas_and_reference(B, S, H, KV, hd, causal,
                                                  window):
    from repro.kernels.flash_attention.ops import flash_attention as jax_fa
    from repro.kernels.flash_attention.ref import (
        flash_attention_reference as jax_ref)
    q, k, v = _attn_data(B, S, H, KV, hd, B * S + H + window)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    for ref in (jax_fa(q, k, v, causal=causal, window=window),
                jax_ref(q, k, v, causal=causal, window=window)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)


def test_flash_plain_bf16_matches_pallas():
    from repro.kernels.flash_attention.ops import flash_attention as jax_fa
    q, k, v = _attn_data(1, 128, 4, 2, 64, 0)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    ref = jax_fa(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                 causal=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=5e-2, atol=5e-2)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def _decode_data(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,KV,hd,pos,ring", [
    (2, 1024, 8, 2, 64, 500, False),
    (1, 512, 4, 4, 32, 511, False),
    (2, 256, 8, 1, 64, 700, True),        # ring wrapped: every slot valid
    (2, 256, 8, 1, 64, 100, True),        # ring not yet full
    (1, 512, 32, 8, 80, 0, False),
])
def test_decode_plain_matches_pallas_and_reference(B, S, H, KV, hd, pos,
                                                   ring):
    from repro.kernels.decode_attention.ops import decode_attention as jax_da
    from repro.kernels.decode_attention.ref import (
        decode_attention_reference as jax_ref)
    q, ck, cv = _decode_data(B, S, H, KV, hd, B * S + pos)
    out = decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                           torch.from_numpy(cv),
                           torch.full((B,), pos, dtype=torch.int32), ring=ring)
    for ref in (jax_da(q, ck, cv, jnp.int32(pos), ring=ring),
                jax_ref(q, ck, cv, jnp.int32(pos), ring=ring)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("ring", [False, True])
def test_decode_per_slot_positions(ring):
    """Every slot attends at its own position: the (B,) vector equals the
    scalar-position JAX kernel run slot by slot, ring wrap included."""
    from repro.kernels.decode_attention.ops import decode_attention as jax_da
    S = 64
    pos = [3, 63, 64, 150] if ring else [0, 17, 40, 63]
    q, ck, cv = _decode_data(len(pos), S, 8, 2, 32, 11)
    out = decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                           torch.from_numpy(cv),
                           torch.tensor(pos, dtype=torch.int32), ring=ring)
    for b, p in enumerate(pos):
        ref = jax_da(q[b:b + 1], ck[b:b + 1], cv[b:b + 1], jnp.int32(p),
                     ring=ring)
        np.testing.assert_allclose(out.numpy()[b:b + 1], np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S,hd,pos,ring", [
    (256, 64, [0, 0], False),                # one live row in span 0
    (256, 64, [63, 63], False),              # the last row of span 0
    (256, 64, [64, 64], False),              # the first row of span 1
    (256, 64, [255, 255], False),            # every span full
    (200, 80, [199, 130], False),            # S not a multiple of the span
    (256, 64, [300, 511], True),             # ring wrapped past S
    (256, 64, [700, 127], True),             # wrapped; ring not yet full
    (256, 64, [-1, -1], True),               # no valid key
    (256, 64, [-1, 5], False),               # no valid key beside a live slot
    (256, 128, [0, 63, 64, 255], False),     # span edges side by side
])
def test_decode_split_plain_matches_pallas(S, hd, pos, ring):
    """The split kernel's partials over spans of 64 rows and the combine
    kernel's log-sum-exp merge (`decode_attention_split_plain`, the two
    CUDA kernels' steps in plain torch) against the JAX package's decode
    kernel, run slot by slot at each slot's scalar position, 2e-5 in f32."""
    from repro.kernels.decode_attention.ops import decode_attention as jax_da
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_split_plain)
    q, ck, cv = _decode_data(len(pos), S, 8, 2, hd, S + 64 + pos[0])
    out = decode_attention_split_plain(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        torch.tensor(pos, dtype=torch.int32), ring=ring)
    assert torch.isfinite(out).all()
    for b, p in enumerate(pos):
        ref = jax_da(q[b:b + 1], ck[b:b + 1], cv[b:b + 1], jnp.int32(p),
                     ring=ring)
        np.testing.assert_allclose(out.numpy()[b:b + 1], np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)
        if p < 0:
            assert (out[b] == 0).all()


def test_decode_slot_with_no_valid_key_outputs_zero():
    q, ck, cv = _decode_data(2, 16, 4, 2, 16, 1)
    out = decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        torch.tensor([-1, 5], dtype=torch.int32), ring=True)
    assert (out[0] == 0).all() and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# wrappers: CPU tensors take the plain version, never a CUDA launch
# ---------------------------------------------------------------------------

def _ivf_args(device="cpu", C=3, L=8, D=16, m=4, nbits=8):
    """(queries, q_probe, sup_cm, ids_cm, inv_cm, codes_cm, anchors,
    codebooks) of a tiny index."""
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (t(_unit(rng.normal(size=(2, D)))),
            t(np.array([[0, 2], [1, 0]], np.int32)),
            t(rng.normal(size=(C, L, D)).astype(np.float32)),
            t(np.arange(C * L, dtype=np.int32).reshape(C, L)),
            t(np.ones((C, L), np.float32)),
            t(rng.integers(0, 2 ** nbits, (C, m * nbits // 8, L)
                           ).astype(np.uint8)),
            t(rng.normal(size=(C, D)).astype(np.float32)),
            t(rng.normal(size=(m, 2 ** nbits, D // m)).astype(np.float32)))


def test_wrappers_on_cpu_run_plain_versions_and_count_no_launch():
    before = (knn_topk.launches, flash_attention.launches,
              decode_attention.launches, ivf_scan.launches,
              ivfpq_adc.launches)
    q, s = _knn_data(4, 40, 8, 2)
    knn_topk(torch.from_numpy(q), torch.from_numpy(s), 5)
    a, b, c = _attn_data(1, 32, 2, 2, 16, 0)
    flash_attention(*(torch.from_numpy(x) for x in (a, b, c)))
    dq, dk, dv = _decode_data(1, 16, 2, 1, 16, 0)
    decode_attention(torch.from_numpy(dq), torch.from_numpy(dk),
                     torch.from_numpy(dv), torch.tensor([3], dtype=torch.int32))
    q, probe, sup, ids, inv, codes, anchors, cb = _ivf_args()
    ivf_scan(q, probe, sup, ids, inv, 5)
    ivfpq_adc(q, probe, codes, ids, inv, anchors, cb, 5, m=4, nbits=8)
    assert (knn_topk.launches, flash_attention.launches,
            decode_attention.launches, ivf_scan.launches,
            ivfpq_adc.launches) == before


def test_wrappers_never_fall_back_on_a_non_cpu_tensor():
    """Only CPU tensors take the plain version: any other device goes to
    the kernel path, which refuses what it cannot launch."""
    q, s = _knn_data(4, 40, 8, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        knn_topk(torch.from_numpy(q).to("meta"),
                 torch.from_numpy(s).to("meta"), 5)
    a = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(a, a, a)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(torch.zeros((1, 2, 64), device="meta"), a, a,
                         torch.zeros((1,), dtype=torch.int32, device="meta"))
    q, probe, sup, ids, inv, codes, anchors, cb = _ivf_args("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ivf_scan(q, probe, sup, ids, inv, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        ivfpq_adc(q, probe, codes, ids, inv, anchors, cb, 5, m=4, nbits=8)
