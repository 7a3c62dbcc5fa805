"""The port's CUDA kernels against their plain-torch versions on a GPU.

Marked `gpu`; each test skips (deciding inside the test) where there is
no CUDA device.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports torch and numpy only, so it runs where JAX is not
installed; the JAX parity of the plain versions is held in
`test_torch_kernels.py` on the CPU.  Tolerances: 1e-5 for kNN scores,
2e-5 for f32 attention, 5e-2 for bf16 (`tests/test_kernels.py`'s)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_reference  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_reference  # noqa: E402
from repro_torch.kernels.knn_topk.ops import knn_topk  # noqa: E402
from repro_torch.kernels.knn_topk.ref import knn_topk_reference  # noqa: E402


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _knn_data(Q, N, D, seed):
    rng = np.random.default_rng(seed)
    return (_unit(rng.normal(size=(Q, D))),
            rng.normal(size=(N, D)).astype(np.float32))


def _attn_data(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32))


def _decode_data(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("Q,N,k", [(16, 70_000, 10), (33, 5_003, 100),
                                   (7, 50, 64)])
def test_gpu_knn_kernel_matches_plain(Q, N, k):
    _need_cuda()
    q, s = _knn_data(Q, N, 768, N)
    qd, sd = torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()
    n0 = knn_topk.launches
    ks, ki = knn_topk(qd, sd, k)
    rs, ri = knn_topk_reference(qd, sd, k)
    assert knn_topk.launches == n0 + 1
    torch.testing.assert_close(ks, rs, rtol=1e-5, atol=1e-5)
    assert torch.equal(ki < 0, ri < 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd,window,tol", [
    (torch.float32, 64, 0, 2e-5), (torch.bfloat16, 128, 32, 5e-2),
    (torch.float32, 80, 16, 2e-5)])
def test_gpu_flash_kernel_matches_plain(dtype, hd, window, tol):
    _need_cuda()
    q, k, v = (torch.from_numpy(x).cuda().to(dtype)
               for x in _attn_data(2, 100, 8, 2, hd, hd))
    out = flash_attention(q, k, v, causal=True, window=window)
    ref = flash_attention_reference(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd,ring,tol", [
    (torch.bfloat16, 128, False, 5e-2), (torch.bfloat16, 80, True, 5e-2),
    (torch.float32, 64, True, 2e-5)])
def test_gpu_decode_kernel_matches_plain(dtype, hd, ring, tol):
    _need_cuda()
    q, ck, cv = (torch.from_numpy(x).cuda().to(dtype)
                 for x in _decode_data(4, 100, 32, 8, hd, hd))
    pos = torch.tensor([0, 99, 150, 37], dtype=torch.int32, device="cuda")
    if not ring:
        pos = pos.clamp(max=99)
    out = decode_attention(q, ck, cv, pos, ring=ring)
    ref = decode_attention_reference(q, ck, cv, pos, ring=ring)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
