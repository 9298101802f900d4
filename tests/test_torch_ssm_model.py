"""Reduced mamba2 (ssm) and zamba2 (hybrid) models: weights made by the
JAX ``LanguageModel.init`` and converted with ``params_from_numpy`` give
the reference's prefill logits and caches, decode-step logits, and
``train_loss`` with its gradients (fp32, CPU).

Tolerance: logits and caches 1e-4 (absolute and relative, summation
order only), argmax identical; gradients 1e-4 of each leaf's largest
|entry|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.model import LanguageModel as JModel
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models.model import LanguageModel as TModel

ATOL = 1e-4
STEPS = 3
ARCHS = ("mamba2-1.3b", "zamba2-1.2b")


def _pair(arch, **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    tcfg = dataclasses.replace(tget(arch).reduced(), **over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    return jm, jp, TModel(tcfg, device="cpu"), tp


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _jtree(tree):
    """A JAX tree of dicts as nested plain dicts of numpy arrays."""
    return {k: _jtree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _pad_seq(cache, n):
    """Extend the reference's head-major k/v caches by n positions."""
    def pad(path, a):
        if path[-1].key in ("k", "v"):
            widths = [(0, 0)] * a.ndim
            widths[-2] = (0, n)
            return jnp.pad(a, widths)
        return a
    return jax.tree_util.tree_map_with_path(pad, cache)


@pytest.mark.parametrize("arch,seq,over", [
    ("mamba2-1.3b", 32, {}),
    ("mamba2-1.3b", 37, {}),                        # ragged: chunk 16
    ("zamba2-1.2b", 24, {}),
    ("zamba2-1.2b", 21, {"num_layers": 5}),         # 2 groups + remainder 1
    ("zamba2-1.2b", 40, {"attn_flash_min_seq": 8}),     # the K1 branch
])
def test_prefill_and_decode_match_reference(arch, seq, over, monkeypatch):
    jm, jp, tm, tp = _pair(arch, **over)
    flash_calls = []
    plain = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **k: flash_calls.append(1) or plain(*a, **k))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jm.cfg.vocab_size, (2, seq)).astype(np.int32)

    jlog, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()})
    _close(tlog, jlog)
    jflat = dict(_leaves(_jtree(jcache)))
    tflat = dict(_leaves(tcache))
    assert set(tflat) == set(jflat)
    for path, leaf in tflat.items():
        _close(leaf, jflat[path])

    jcache = _pad_seq(jcache, STEPS)
    tcache = tm.alloc_cache(2, seq + STEPS, init=tcache)
    jstep = jax.jit(jm.decode_step)
    for i in range(STEPS):
        tok = rng.randint(0, jm.cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = jstep(jp, jcache, jnp.asarray(tok),
                             jnp.asarray(seq + i, jnp.int32))
        tlog, tcache = tm.decode_step(tp, tcache,
                                      torch.from_numpy(tok).long(), seq + i)
        _close(tlog, jlog)
        assert np.array_equal(tlog.argmax(-1).numpy(),
                              np.asarray(jlog).argmax(-1))
    jflat = dict(_leaves(_jtree(jcache)))
    for path, leaf in _leaves(tcache):
        _close(leaf, jflat[path])
    groups = (jm.cfg.num_layers // jm.cfg.attn_every
              if jm.cfg.family == "hybrid" else 0)
    assert len(flash_calls) == (groups if over.get("attn_flash_min_seq")
                                else 0)


@pytest.mark.parametrize("arch,over", [("mamba2-1.3b", {}),
                                       ("zamba2-1.2b", {"num_layers": 5})])
def test_alloc_cache_has_the_reference_cache_spec(arch, over):
    jm, _, tm, _ = _pair(arch, **over)
    want = {p: (tuple(s.shape), s.dtype.name)
            for p, s in _leaves(jm.cache_spec(3, 50))}
    cache = tm.alloc_cache(3, 50)
    got = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for p, t in _leaves(cache)}
    assert got == want
    assert all(not t.any() for _, t in _leaves(cache))


@pytest.mark.parametrize("arch,seq", [("mamba2-1.3b", 32), ("mamba2-1.3b", 37),
                                      ("zamba2-1.2b", 32)])
def test_train_loss_and_grads_match_jax_grad(arch, seq):
    jm, jp, tm, tp = _pair(arch)
    rng = np.random.RandomState(2)
    batch = {k: rng.randint(0, jm.cfg.vocab_size, (2, seq)).astype(np.int32)
             for k in ("tokens", "targets")}
    (jloss, jmet), jgrad = jax.value_and_grad(jm.train_loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    for _, leaf in _leaves(tp):
        leaf.requires_grad_()
    tloss, tmet = tm.train_loss(tp, {k: torch.from_numpy(v).long()
                                     for k, v in batch.items()})
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["ce_loss"].detach()),
                               float(jmet["ce_loss"]),
                               rtol=1e-5)
    jflat = dict(_leaves(_jtree(jgrad)))
    for path, leaf in _leaves(tp):
        want = jflat[path]
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-8),
                                   err_msg=".".join(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """The serving contract of ``tests/test_models.py``: prefill(S) then
    decode(token S) equals prefill(S + 1) at the last position."""
    cfg = tget(arch).reduced()
    model = TModel(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(3)
    b, s = 2, 64
    full = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen)
    truth, _ = model.prefill(params, {"tokens": full})
    _, cache = model.prefill(params, {"tokens": full[:, :-1]})
    cache = model.alloc_cache(b, s + 1, init=cache)
    got, _ = model.decode_step(params, cache, full[:, -1:], s)
    np.testing.assert_allclose(got.numpy(), truth.numpy(), atol=2e-2,
                               rtol=2e-2)
    assert (got.argmax(-1) == truth.argmax(-1)).float().mean() >= 0.95


def test_hybrid_shared_attention_is_shared():
    """zamba2: one attention block's weights serve every application —
    the parameter tree holds exactly one copy, with no layer axis."""
    cfg = tget("zamba2-1.2b").reduced()
    model = TModel(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert "shared_attn" in params
    wq = params["shared_attn"]["attn"]["w_q"]
    assert wq.dim() == 3                      # no leading per-application dim
    g, rem = model._hybrid_segments()
    assert g == cfg.num_layers // cfg.attn_every
    assert rem == cfg.num_layers - g * cfg.attn_every
    assert params["layers"]["mixer"]["w_x"].shape[0] == cfg.num_layers


def test_params_from_numpy_checks_each_family():
    jm, jp, _, _ = _pair("zamba2-1.2b")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = tget("zamba2-1.2b").reduced()
    wide = dataclasses.replace(tcfg, expand=3)
    with pytest.raises(ValueError, match="layers.mixer.w_x"):
        params_from_numpy(tree, wide, device="cpu")
    no_shared = {k: v for k, v in tree.items() if k != "shared_attn"}
    with pytest.raises(ValueError, match="shared_attn.attn.w_q"):
        params_from_numpy(no_shared, tcfg, device="cpu")
    ssm = dataclasses.replace(tcfg, family="ssm")
    assert "shared_attn" in params_from_numpy(tree, ssm, device="cpu")
    with pytest.raises(ValueError, match="layers.attn.w_q"):
        params_from_numpy(tree, tget("smollm-360m").reduced(), device="cpu")


def _gap(logits_decode, logits_full):
    d = np.asarray(logits_decode, np.float32) - np.asarray(logits_full,
                                                           np.float32)
    agree = np.mean(np.argmax(logits_decode, -1) == np.argmax(logits_full,
                                                              -1))
    return float(np.sqrt(np.mean(d * d))), float(np.abs(d).max()), agree


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_decode_gap_is_the_references(arch):
    """In bf16, prefill(S) + decode(token S) and prefill(S + 1) round
    different intermediates, so their last logits differ by more than
    summation order, and argmax can flip where the top two are close.
    The reference has that gap too, on the same weights: the port's RMS
    gap stays within 2x the reference's, and zamba2's, whose attention
    decode rounds as the reference's, within 1.25x.  SSM widths as served (P 64,
    N as the config, chunk 128) at d_model 512, 4 layers.  Run with -s
    to print both gaps."""
    over = dict(dtype="bfloat16", param_dtype="bfloat16", num_layers=4,
                d_model=512, vocab_size=4096, ssm_head_dim=64,
                ssm_chunk=128, ssm_state=jget(arch).ssm_state)
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    tcfg = dataclasses.replace(tget(arch).reduced(), **over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp), tcfg, device="cpu")
    tm = TModel(tcfg, device="cpu")
    b, s = 16, 160
    full = np.random.RandomState(3).randint(0, jcfg.vocab_size,
                                            (b, s + 1)).astype(np.int32)
    jfull, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(full)})
    _, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(full[:, :-1])})
    jdec, _ = jax.jit(jm.decode_step)(jp, _pad_seq(jcache, 1),
                                      jnp.asarray(full[:, -1:]),
                                      jnp.asarray(s, jnp.int32))
    tokens = torch.from_numpy(full).long()
    with torch.no_grad():
        tfull, _ = tm.prefill(tp, {"tokens": tokens})
        _, tcache = tm.prefill(tp, {"tokens": tokens[:, :-1]})
        tcache = tm.alloc_cache(b, s + 1, init=tcache)
        tdec, _ = tm.decode_step(tp, tcache, tokens[:, -1:], s)
    jgap = _gap(np.asarray(jdec.astype(jnp.float32)),
                np.asarray(jfull.astype(jnp.float32)))
    tgap = _gap(tdec.float().numpy(), tfull.float().numpy())
    print(f"{arch} bf16, B={b} S={s}: prefill/decode gap RMS, max, argmax "
          f"agreement: reference {jgap[0]:.4f} {jgap[1]:.4f} {jgap[2]:.3f}; "
          f"port {tgap[0]:.4f} {tgap[1]:.4f} {tgap[2]:.3f}")
    assert 0 < jgap[0] and tgap[0] <= 2 * jgap[0]
    if arch == "zamba2-1.2b":
        # the shared attention's CPU decode rounds P to bf16 as the
        # reference's does, so the hybrid's gap is the reference's size
        assert tgap[0] <= 1.25 * jgap[0]
