"""Card-only checks: the CUDA kernels K1 and K5 against their plain
PyTorch versions on the same inputs.  They skip (from inside the fixture)
where torch sees no CUDA device; on a machine with the card run

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd

pytestmark = pytest.mark.cuda

# bf16 inputs, fp32 arithmetic on both sides: they differ only in the
# order of the sums and the final bf16 rounding of the output (one bf16
# ulp is 2^-8 relative), so 2e-2 absolute on O(1) outputs; fp32 differs
# only in summation order
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        device=device, dtype=dtype)


@pytest.mark.parametrize("b,h,kh,sq,sk,hd,dtype,window,q_offset", [
    (1, 6, 2, 300, 300, 64, torch.bfloat16, 0, 0),      # ragged edge
    (2, 4, 4, 256, 256, 128, torch.bfloat16, 0, 0),     # MHA, hd 128
    (1, 15, 5, 200, 200, 64, torch.float32, 0, 0),      # fp32, G = 3
    (1, 6, 3, 333, 333, 64, torch.bfloat16, 100, 0),    # window
    (2, 8, 2, 130, 390, 64, torch.bfloat16, 0, 260),    # q stripe offset
    (1, 4, 1, 129, 257, 128, torch.float32, 64, 128),   # MQA, all of it
])
def test_flash_attention_kernel_matches_plain(cuda, b, h, kh, sq, sk, hd,
                                              dtype, window, q_offset):
    q = _randn((b, h, sq, hd), dtype, cuda, 0)
    k = _randn((b, kh, sk, hd), dtype, cuda, 1)
    v = _randn((b, kh, sk, hd), dtype, cuda, 2)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, q_offset, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, q_offset, causal=True,
                                    window=window)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("b,kh,g,s,hd,cur,window,dtype", [
    (4, 5, 3, 2624, 64, 2561, 0, torch.bfloat16),
    (4, 5, 3, 2624, 64, 2600, 512, torch.bfloat16),
    (2, 2, 4, 300, 128, 1, 0, torch.float32),
    (2, 2, 8, 256, 64, 256, 16, torch.float32),
    (1, 3, 1, 1000, 128, 777, 0, torch.bfloat16),
])
def test_flash_decode_kernel_matches_plain(cuda, b, kh, g, s, hd, cur,
                                           window, dtype):
    q = _randn((b, kh, g, hd), dtype, cuda, 3)
    kc = _randn((b, kh, s, hd), dtype, cuda, 4)
    vc = _randn((b, kh, s, hd), dtype, cuda, 5)
    cur_t = torch.full((1,), cur, dtype=torch.int32, device=cuda)
    before = fd.flash_decode.launches
    got = fd.flash_decode(q, kc, vc, cur_t, window=window)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    want = fd.flash_decode_plain(q, kc, vc, cur_t, window=window)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 2, 8, 32), device=cuda)          # head_dim 32
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 1, 2, 64), device=cuda)
    kc = torch.zeros((1, 1, 16, 64), device=cuda)
    with pytest.raises(TypeError):                        # int64 cur_len
        fd.flash_decode(q, kc, kc, torch.ones(1, dtype=torch.int64,
                                              device=cuda))
