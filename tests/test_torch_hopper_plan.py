"""The wgmma kernels' plans at the head-width pairs (64, 64) and (128, 128),
on the CPU.

``csrc/flash_attention_hopper.cu`` runs K1, K1-lse, K2's dk/dv and K3 in
bf16 at those pairs.  Its host-side arithmetic has a Python mirror in
``kernels/autotune.py``, held here without a card:

* each kernel's shared memory fits the 232,448 B a block may opt into and
  equals the sums the ``.cu`` holds in its static_asserts;
* which kernels each (hd, hd_v, dtype) takes (``autotune.attn_route``);
* K1's kv tiles for each 128-row q tile and the dk/dv block's 64-row q
  tiles for each 128-row kv block, against a brute-force mask: every live
  (q, k) pair is met exactly once and no tile without a live pair is
  visited;
* K1's heaviest-first launch order visits each q tile once;
* the wrappers' meta route counts the same FLOPs and bytes as
  ``kernels/counts.py`` says.

On the card (marker ``cuda``) the last test holds the mirror against the
``.cu``'s own range functions, the ones the kernels call;
``tests/test_torch_cuda.py`` holds the kernels themselves.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune, counts
from repro_torch.kernels import flash_attention as fa

SRC = (Path(fa.__file__).resolve().parent / "csrc"
       / "flash_attention_hopper.cu")


def _asserted_bytes():
    """{(kernel, hd): bytes} from the .cu's static_asserts."""
    text = SRC.read_text()
    out = {}
    for name, hd, dq, n in re.findall(
            r"(fwd|bwd)_bytes<(\d+)(?:, (\w+))?>\(\) == (\d+)", text):
        kernel = "k1" if name == "fwd" else "k3" if dq == "true" else "k2_dkv"
        out[(kernel, int(hd))] = int(n)
    return out


def test_smem_plans_fit_and_equal_the_kernels_sums():
    asserted = _asserted_bytes()
    assert set(asserted) == {(k, hd) for k in ("k1", "k2_dkv", "k3")
                             for hd in (64, 128)}
    for (kernel, hd), n in asserted.items():
        assert autotune.hopper_smem_bytes(kernel, hd) == n
        assert 0 < n <= autotune.SMEM_OPTIN_BYTES
    with pytest.raises(ValueError):
        autotune.hopper_smem_bytes("k1", 192)


@pytest.mark.parametrize("hd,hd_v,itemsize,route", [
    (64, 64, 2, "wgmma"), (32, 32, 2, "wgmma"), (48, 32, 2, "wgmma"),
    (128, 128, 2, "wgmma"), (120, 120, 2, "wgmma"), (72, 64, 2, "wgmma"),
    (192, 128, 2, "mma.sync"), (136, 128, 2, "mma.sync"),
    (576, 512, 2, "wide"), (256, 256, 2, "wide"),
    (64, 64, 4, "cuda_cores"), (128, 128, 4, "cuda_cores"),
    (192, 128, 4, "cuda_cores"), (576, 512, 4, "cuda_cores"),
])
def test_route_of_each_width_and_dtype(hd, hd_v, itemsize, route):
    assert autotune.attn_route(hd, hd_v, itemsize) == route
    if route == "wgmma":
        assert autotune.kernel_head_dim(hd, hd_v) in autotune.HOPPER_PAIRS


def test_route_refuses_widths_no_pair_holds():
    with pytest.raises(ValueError):
        autotune.attn_route(584, 512, 2)


def _live(sq, sk, q_offset, causal, window):
    """(sq, sk) bool: the reference's mask of real rows and columns."""
    rows = q_offset + np.arange(sq)[:, None]
    cols = np.arange(sk)[None, :]
    live = np.ones((sq, sk), dtype=bool)
    if causal:
        live &= cols <= rows
    if window > 0:
        live &= rows - cols < window
    return live


SHAPES = [  # sq, sk, q_offset, causal, window
    (300, 300, 0, True, 0),
    (601, 601, 0, True, 0),          # ragged past a whole tile
    (1, 1, 0, True, 0),
    (100, 50, 10, True, 0),          # Sk < a tile, q_offset
    (1100, 1400, 300, True, 0),      # q_offset, ragged Sq and Sk
    (700, 900, 200, True, 300),      # window and q_offset
    (1000, 1000, 0, True, 300),
    (1000, 1000, 0, True, 64),       # a window narrower than a tile
    (640, 640, 0, True, 4096),       # a window past the sequence
    (257, 400, 143, True, 0),
    (300, 300, 0, False, 0),         # no mask
    (130, 1000, 0, True, 0),         # Sq just past a tile, Sk far longer
    (130, 1000, 100, True, 0),       # the same at a q_offset off the tiles
]


@pytest.mark.parametrize("sq,sk,q_offset,causal,window", SHAPES)
def test_k1_kv_tiles_meet_every_live_pair_once(sq, sk, q_offset, causal,
                                               window):
    live = _live(sq, sk, q_offset, causal, window)
    qr, bk = autotune.HOPPER_Q_ROWS, autotune.HOPPER_K1_ROWS
    met = np.zeros_like(live, dtype=int)
    for q0 in autotune.hopper_q_order(sq):
        kt0, n = autotune.hopper_kv_tiles(q0, sq, sk, q_offset, causal,
                                          window)
        assert kt0 % bk == 0 and n >= 0
        for k0 in range(kt0, kt0 + n * bk, bk):
            block = live[q0:q0 + qr, k0:k0 + bk]
            assert block.any(), (q0, k0)       # no tile without a live pair
            met[q0:q0 + qr, k0:k0 + bk] += 1
    assert (met[live] == 1).all()
    assert (met <= 1).all()


@pytest.mark.parametrize("sq,sk,q_offset,causal,window", SHAPES)
def test_dkv_q_tiles_meet_every_live_pair_once(sq, sk, q_offset, causal,
                                               window):
    live = _live(sq, sk, q_offset, causal, window)
    kr, tq = autotune.HOPPER_KV_ROWS, autotune.HOPPER_Q_TILE
    met = np.zeros_like(live, dtype=int)
    for k0 in range(0, sk, kr):
        qt0, n = autotune.hopper_q_tiles(k0, sq, sk, q_offset, causal,
                                         window)
        assert qt0 % tq == 0 and n >= 0
        for q0 in range(qt0, qt0 + n * tq, tq):
            assert live[q0:q0 + tq, k0:k0 + kr].any(), (k0, q0)
            met[q0:q0 + tq, k0:k0 + kr] += 1
    assert (met[live] == 1).all()
    assert (met <= 1).all()


@pytest.mark.parametrize("sq", [1, 127, 128, 129, 3008, 4096, 6000])
def test_k1_launch_order_is_heaviest_first_and_visits_each_q_tile_once(sq):
    order = autotune.hopper_q_order(sq)
    qr = autotune.HOPPER_Q_ROWS
    assert sorted(order) == list(range(0, sq, qr))
    tiles = [autotune.hopper_kv_tiles(q0, sq, sq, 0, True, 0)[1]
             for q0 in order]
    assert tiles == sorted(tiles, reverse=True)


@pytest.mark.parametrize("hd,hd_v,kh", [(64, 64, 5), (128, 128, 8),
                                        (120, 120, 8), (48, 32, 8),
                                        (32, 32, 2)])
def test_meta_route_counts_what_counts_py_says(hd, hd_v, kh):
    b, h, s = 2, 2 * kh, 300

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    q, k, v, do = (meta(b, h, s, hd), meta(b, kh, s, hd), meta(b, kh, s, hd_v),
                   meta(b, h, s, hd_v))
    lse = torch.empty((b, h, s), device="meta")
    counts.reset()
    fa.flash_attention_fwd(q, k, v, 7, window=100)
    fa.flash_attention(q, k, v, 7, window=100)
    fa.flash_attention_bwd_dkv(q, k, v, do, lse, lse, 7, window=100)
    dq, dk, dv = fa.flash_attention_bwd_fused(q, k, v, do, lse, lse, 7,
                                              window=100)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    for name in ("k1_lse", "k1", "k2_dkv", "k3"):
        want = counts.attention_work(name, b, h, kh, s, s, hd, hd_v, 7, True,
                                     100, 2)
        assert counts.KERNELS[name] == [1, *want]


@pytest.mark.cuda
def test_the_mirror_is_the_kernels_arithmetic():
    """autotune's ranges against the .cu's own range functions, which the
    kernels call (``fa.hopper_ranges`` runs them on the host; the library
    builds only where nvcc is): every q tile and kv block of SHAPES and of
    400 random cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.RandomState(0)
    shapes = SHAPES + [
        (int(rng.randint(1, 3000)), int(rng.randint(1, 3000)),
         int(rng.randint(0, 700)), bool(rng.randint(2)),
         int(rng.choice([0, 1, 64, 127, 300, 4096])))
        for _ in range(400)]
    kv, qt, order = [], [], []
    for sq, sk, q_offset, causal, window in shapes:
        kv += [(q0, sq, sk, q_offset, int(causal), window)
               for q0 in range(0, sq, autotune.HOPPER_Q_ROWS)]
        qt += [(k0, sq, sk, q_offset, int(causal), window)
               for k0 in range(0, sk, autotune.HOPPER_KV_ROWS)]
        ny = -(-sq // autotune.HOPPER_Q_ROWS)
        order.append((sq, [(y, ny) for y in range(ny)]))
    want_kv = [autotune.hopper_kv_tiles(*c[:4], bool(c[4]), c[5]) for c in kv]
    want_qt = [autotune.hopper_q_tiles(*c[:4], bool(c[4]), c[5]) for c in qt]
    assert [tuple(r) for r in fa.hopper_ranges("kv_tiles", kv)] == want_kv
    assert [tuple(r) for r in fa.hopper_ranges("q_tiles", qt)] == want_qt
    for sq, cases in order:
        got = fa.hopper_ranges("q_order", cases)[:, 0]
        assert tuple(got) == autotune.hopper_q_order(sq)
