"""K9's tensor-core route, held on the CPU: its two stages in plain
PyTorch (``ssd_chunk_states_plain``, the state entering every chunk, and
``ssd_chunk_scan_plain``, y from those states) composed against
``ssd_scan_plain``, the reference's ``ssd_chunked`` and the Pallas
``ssd_scan`` in interpret mode, on the same numpy inputs; the entering
states against the reference's sequential recurrence run on each prefix;
the pure route function and K9y's head grouping; the scratch's hi + lo
decoding.

fp32 tolerance: 1e-4 relative, with the absolute part scaled by the
largest |value| (the sides differ in summation order only: the chunked
forms sum C·Bᵀ, att·x and the state products in other orders than the
recurrence, over up to S terms).  bf16 inputs are rounded once before
both sides, which then compute in fp32, so they are held to the same
limit.  The two stages composed are held to ``ssd_scan_plain`` bit for
bit: they run its arithmetic in its order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.mamba import ssd_chunked as jssd_chunked
from repro_torch.kernels import ssd_scan as tssd

RTOL = 1e-4


def _inputs(b, s, h, p, n, seed, bf16=False):
    """Model layout: x (b,s,h,p), dt (b,s,h) > 0, A (h,) < 0, B/C (b,s,n);
    with ``bf16`` x, B and C are rounded to bf16 (and kept as fp32)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32)
    A = (-np.exp(rng.randn(h) * 0.5)).astype(np.float32)
    B = rng.randn(b, s, n).astype(np.float32)
    C = rng.randn(b, s, n).astype(np.float32)
    if bf16:
        x, B, C = (torch.from_numpy(a).bfloat16().float().numpy()
                   for a in (x, B, C))
    return x, dt, A, B, C


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _kernel_layout(x, dt, A, B, C, dtype=torch.float32):
    """Torch tensors in K9's layout: x (b,h,s,p), dt (b,h,s)."""
    return (torch.from_numpy(np.ascontiguousarray(
                x.transpose(0, 2, 1, 3))).to(dtype),
            torch.from_numpy(np.ascontiguousarray(dt.transpose(0, 2, 1))),
            torch.from_numpy(A), torch.from_numpy(B).to(dtype),
            torch.from_numpy(C).to(dtype))


def _staged(args, chunk):
    entering, final = tssd.ssd_chunk_states_plain(*args[:4], chunk=chunk)
    return tssd.ssd_chunk_scan_plain(*args, entering, chunk=chunk), final


# ragged S, S shorter than the chunk (the prompts of 40, 70 and 100
# tokens), mamba2's N 128 and zamba2's N 64
CASES = [  # b, s, h, p, n, chunk
    (2, 200, 3, 64, 128, 64),       # ragged: 3 chunks and 8 positions
    (1, 300, 2, 64, 64, 128),       # ragged, zamba2's N
    (2, 40, 2, 64, 128, 128),       # S < chunk: one chunk of 40
    (1, 70, 3, 64, 128, 128),
    (1, 100, 2, 64, 64, 128),
    (2, 96, 4, 16, 16, 32),         # the tc route's smallest P and N
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_stages_compose_to_the_plain_version_and_ssd_chunked(
        b, s, h, p, n, chunk, bf16):
    x, dt, A, B, C = _inputs(b, s, h, p, n, s + n, bf16)
    args = _kernel_layout(x, dt, A, B, C)
    y, st = _staged(args, chunk)
    yp, stp = tssd.ssd_scan_plain(*args, chunk=chunk)
    assert torch.equal(y, yp) and torch.equal(st, stp)
    yj, stj = jssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)),
                           min(chunk, s))
    _close(y.transpose(1, 2), yj)
    _close(st, stj)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 128, 2, 64, 128, 32),
    (2, 64, 2, 64, 64, 64),         # one chunk
    (1, 96, 3, 16, 32, 16),
])
def test_stages_compose_to_the_pallas_kernel(b, s, h, p, n, chunk):
    x, dt, A, B, C = _inputs(b, s, h, p, n, 3 * s + n)
    yj, stj = jops.ssd_scan(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk,
                            interpret=True)
    y, st = _staged(_kernel_layout(x, dt, A, B, C), chunk)
    _close(y.transpose(1, 2), yj)
    _close(st, stj)


def test_bf16_stages_round_y_once():
    """bf16 operands: y comes back in bf16, one rounding of the fp32 sum."""
    x, dt, A, B, C = _inputs(1, 70, 2, 64, 128, 5)
    args = _kernel_layout(x, dt, A, B, C, torch.bfloat16)
    y, st = _staged(args, 128)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    yj, stj = jssd_chunked(*(jnp.asarray(a.float().numpy()) for a in (
        args[0].transpose(1, 2), args[1].transpose(1, 2), *args[2:])), 70)
    want = np.asarray(yj).transpose(0, 2, 1, 3)
    d = np.abs(y.float().numpy() - want)
    assert (d <= 2.0 ** -7 * np.abs(want) + 1e-4 * np.abs(want).max()).all()
    _close(st, stj)


@pytest.mark.parametrize("s,chunk", [(200, 64), (96, 32), (40, 128)])
def test_entering_states_match_the_sequential_recurrence(s, chunk):
    """The state entering chunk c is the recurrence's final state over the
    first c·Q positions (zero for chunk 0); the last output is its state
    over all S."""
    b, h, p, n = 2, 2, 16, 32
    x, dt, A, B, C = _inputs(b, s, h, p, n, s)
    entering, final = tssd.ssd_chunk_states_plain(
        *_kernel_layout(x, dt, A, B, C)[:4], chunk=chunk)
    q = min(chunk, s)
    nc = -(-s // q)
    assert entering.shape == (b, h, nc, p, n)
    assert entering.dtype == torch.float32
    assert not entering[:, :, 0].any()
    for c in range(1, nc):
        pre = (a[:, :c * q] for a in (x, dt))
        _, want = jref.ssd_scan_sequential(
            *map(jnp.asarray, (*pre, A, B[:, :c * q], C[:, :c * q])))
        _close(entering[:, :, c], want)
    _, want = jref.ssd_scan_sequential(*map(jnp.asarray, (x, dt, A, B, C)))
    _close(final, want)


@pytest.mark.parametrize("dtype,p,n,chunk,want", [
    (torch.bfloat16, 64, 128, 128, "tc"),     # mamba2
    (torch.bfloat16, 64, 64, 128, "tc"),      # zamba2
    (torch.bfloat16, 64, 128, 40, "tc"),      # a 40-token prompt
    (torch.bfloat16, 16, 16, 1, "tc"),
    (torch.bfloat16, 48, 80, 100, "tc"),
    (torch.float32, 64, 128, 128, "fp32"),    # fp32 keeps the CUDA cores
    (torch.bfloat16, 32, 8, 16, "fp32"),      # N not a multiple of 16
    (torch.bfloat16, 8, 64, 64, "fp32"),      # P below 16
    (torch.bfloat16, 24, 64, 64, "fp32"),
    (torch.bfloat16, 64, 136, 128, "fp32"),   # past the tc range
    (torch.bfloat16, 80, 64, 128, "fp32"),
])
def test_route_is_a_function_of_dtype_and_shape(dtype, p, n, chunk, want):
    assert tssd.route(dtype, p, n, chunk) == want


def test_model_configs_routes():
    """The full-width mamba2 / zamba2 in bf16, as they serve, take tc; the
    reduced ones (P 32, N 16) in fp32, as the card's CPU-parity checks run
    them, take fp32."""
    from repro_torch.configs import get_config
    for arch in ("mamba2-1.3b", "zamba2-1.2b"):
        cfg = get_config(arch)
        small = cfg.reduced()
        assert tssd.route(torch.float32, small.ssm_head_dim, small.ssm_state,
                          small.ssm_chunk) == "fp32"
        assert tssd.route(torch.bfloat16, cfg.ssm_head_dim, cfg.ssm_state,
                          cfg.ssm_chunk) == "tc"


@pytest.mark.parametrize("b,h,nc,want", [
    (4, 64, 32, 8),        # mamba2 4 x 4096: 1,024 blocks in 7.8 waves
    (1, 64, 128, 8),       # mamba2 1 x 16384: the same
    (1, 64, 16, 8),        # mamba2 1 x 2048: 128 blocks, one wave
    (1, 64, 24, 4),        # zamba2 1 x 3000: 8 would leave 1.45 waves
    (1, 4, 1, 1),          # a short prompt of a small model: one wave
])
def test_heads_per_k9y_block(b, h, nc, want):
    """The grouping the card's K9y times favour: G = 8 measured fastest
    at mamba2's 4 x 4096 and 1 x 2048, G = 4 at zamba2's 1 x 3000."""
    assert tssd.tc_group(b, h, nc) == want


@pytest.mark.parametrize("sm_count,want", [(132, 4), (192, 8), (66, 8)])
def test_heads_per_k9y_block_follow_the_cards_sm_count(sm_count, want):
    """The wave model counts the card's own SMs: zamba2's 1 x 3000 (192
    blocks at G = 8) takes G = 8 where they fill whole waves (one on 192
    SMs, three on 66) and G = 4 on 132, where 8 would leave 1.45."""
    assert tssd.tc_group(1, 64, 24, sm_count) == want


def test_states_from_scratch_adds_the_pair():
    """The scratch holds each entering state as bf16 hi + lo, hi = bf16(s),
    lo = bf16(s - hi): the pair is s to ~2^-17 relative."""
    rng = np.random.RandomState(0)
    s = torch.from_numpy(rng.randn(2, 3, 4, 16, 32).astype(np.float32) * 50)
    hi = s.bfloat16()
    lo = (s - hi.float()).bfloat16()
    scratch = torch.stack([hi, lo], dim=3)        # (B, H, nc, 2, P, N)
    got = tssd.states_from_scratch(scratch)
    assert got.dtype == torch.float32 and got.shape == s.shape
    assert ((got - s).abs() <= 2.0 ** -16 * s.abs()).all()


def test_unaligned_rows_are_copied_for_the_tc_route():
    """The tc kernels copy rows by 16 bytes: a view whose rows do not all
    start on 16 bytes is handed over as a dense copy, an aligned one as
    it is."""
    base = torch.zeros(2, 5, 64, dtype=torch.bfloat16)
    assert tssd._aligned(base) is base
    view = base.transpose(0, 1)                 # strides (64, 320, 1)
    assert tssd._aligned(view) is view
    odd = torch.zeros(2, 5, 68, dtype=torch.bfloat16)[..., :64]
    got = tssd._aligned(odd)
    assert got is not odd and got.is_contiguous() and torch.equal(got, odd)
