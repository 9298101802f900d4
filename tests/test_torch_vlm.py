"""llava-next-mistral-7b (the VLM family) with a patch prefix through the
port against the reference's no-mesh model on the CPU, reduced config (2
layers, d 128, 4 heads over 2 kv heads of 32, window 16, 8 patches).

Weights come from the JAX ``init``, carried across with
``params_from_numpy``; tokens and patch embeddings (a normal x 0.02, as
``tests/test_models.py`` draws them) are numpy arrays from a seed.  The
patches go before the text, so the window binds behind them and decode
continues at ``cur_len`` = P + S.  Prefill logits and caches, decode
steps, ``train_loss`` (targets padded with -1 over the patches:
``tokens`` = B x (S - P)) and its gradients, and two ``Trainer`` steps on
one data object whose ``get(i)`` carries ``patches``, each at a length
below ``flash_min_seq`` (8 + 12: the dense attention) and above a lowered
one (8 + 32 with ``attn_flash_min_seq`` 8: the flash kernels' path, their
plain version on the CPU).

Tolerances: fp32, summation order only, values O(1): logits and caches
1e-4, metrics 1e-6 relative, gradients 1e-5 of each leaf's largest
entry, Trainer losses 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import SyntheticTokens as JTokens
from repro.models.model import LanguageModel as JModel
from repro.optim import OptimizerConfig as JOpt
from repro.optim import init_opt_state as jinit
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.data import SyntheticTokens
from repro_torch.models.model import LanguageModel as TModel
from repro_torch.optim import OptimizerConfig
from repro_torch.optim.adamw import init_opt_state, iter_leaves
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "llava-next-mistral-7b"
ATOL = 1e-4
STEPS = 3
B = 2
# (text length, overrides): patches + text below the default threshold
# (dense attention) and above a lowered one (the flash kernels)
SEQS = {"dense": (12, {}), "flash": (32, {"attn_flash_min_seq": 8})}


def _pair(**over):
    jcfg = dataclasses.replace(jget(ARCH).reduced(), **over)
    tcfg = dataclasses.replace(tget(ARCH).reduced(), **over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    return jm, jp, TModel(tcfg, device="cpu"), tp


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _patches(cfg, b=B, seed=7):
    rng = np.random.RandomState(seed)
    return (0.02 * rng.standard_normal(
        (b, cfg.num_patches, cfg.d_model))).astype(np.float32)


def test_reduced_config_has_a_binding_window():
    cfg = tget(ARCH).reduced()
    assert cfg.family == "vlm" and cfg.num_patches == 8
    assert cfg.sliding_window == 16 < cfg.num_patches + SEQS["dense"][0]
    assert cfg.num_kv_heads < cfg.num_heads


@pytest.mark.parametrize("route", list(SEQS))
def test_prefill_and_decode_with_patches_match_reference(route):
    """Prefill logits and the k / v caches over P + S positions against
    the reference's; then ``alloc_cache(B, P + S + STEPS, init=cache)``
    and STEPS decode steps at ``cur_len`` = P + S + i."""
    seq, over = SEQS[route]
    jm, jp, tm, tp = _pair(**over)
    cfg = jm.cfg
    p = cfg.num_patches
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    patches = _patches(cfg)
    jlog, jcache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                                   "patches": torch.from_numpy(patches)})
    _close(tlog, jlog)
    for name in ("k", "v"):
        assert tuple(tcache["layers"][name].shape) == \
            (cfg.num_layers, B, cfg.num_kv_heads, p + seq, cfg.head_dim)
        _close(tcache["layers"][name], jcache["layers"][name])

    tcache = tm.alloc_cache(B, p + seq + STEPS, init=tcache)
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.pad(a, [(0, 0)] * 3 + [(0, STEPS), (0, 0)]), jcache)
    jstep = jax.jit(jm.decode_step)
    for i in range(STEPS):
        tok = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        cur = p + seq + i
        jlog, jcache = jstep(jp, jcache, jnp.asarray(tok),
                             jnp.asarray(cur, jnp.int32))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok), cur)
        _close(tlog, jlog)
    for name in ("k", "v"):
        _close(tcache["layers"][name], jcache["layers"][name])


def test_prefill_decode_matches_full_forward_with_patches():
    """The port's serving contract with a patch prefix, as
    ``tests/test_models.py::test_prefill_decode_matches_full_forward``:
    prefill(P + S) then decode(token S) at ``cur_len`` = P + S equals
    prefill(P + S + 1)'s last logits."""
    _jm, _jp, tm, tp = _pair()
    cfg = tm.cfg
    rng = np.random.RandomState(4)
    full = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, 21)))
    patches = torch.from_numpy(_patches(cfg, seed=5))
    truth, _ = tm.prefill(tp, {"tokens": full, "patches": patches})
    _, cache = tm.prefill(tp, {"tokens": full[:, :-1], "patches": patches})
    cache = tm.alloc_cache(B, cfg.num_patches + 21, init=cache)
    got, _ = tm.decode_step(tp, cache, full[:, -1:], cfg.num_patches + 20)
    _close(got, truth.numpy())


def test_text_only_prefill_matches_reference():
    """A VLM batch without ``patches`` is plain text in both packages."""
    jm, jp, tm, tp = _pair()
    tokens = np.random.RandomState(2).randint(
        0, jm.cfg.vocab_size, (B, 12)).astype(np.int32)
    jlog, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)})
    _close(tlog, jlog)
    assert tcache["layers"]["k"].shape[-2] == 12


def test_patches_are_ignored_outside_vlm():
    """As in the reference's ``_embed``, only the vlm family reads
    ``patches``: a dense model's logits and loss do not change."""
    cfg = tget("smollm-360m").reduced()
    tm = TModel(cfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (B, 13)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    extra = {"patches": torch.ones(B, 8, cfg.d_model)}
    with torch.no_grad():
        a, _ = tm.prefill(tp, {"tokens": batch["tokens"]})
        b, _ = tm.prefill(tp, {"tokens": batch["tokens"], **extra})
        la, _ = tm.train_loss(tp, batch)
        lb, mb = tm.train_loss(tp, {**batch, **extra})
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert float(mb["tokens"]) == B * 12


def _batch(cfg, s, b=B, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy(),
             "patches": _patches(cfg, b, seed + 1)}
    batch["targets"][0, :3] = -1                   # masked targets
    return batch


@pytest.mark.parametrize("route", list(SEQS))
def test_loss_and_grads_with_patches_match_reference(route):
    seq, over = SEQS[route]
    jm, jp, tm, tp = _pair(**over)
    batch = _batch(jm.cfg, seq)
    (_jl, jmet), jg = jax.jit(jax.value_and_grad(jm.train_loss,
                                                 has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [x.requires_grad_() for _p, x in iter_leaves(tp)]
    tl, tmet = tm.train_loss(tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    tg = torch.autograd.grad(tl, leaves)
    assert set(tmet) == set(jmet)
    for k, v in jmet.items():
        np.testing.assert_allclose(float(tmet[k].detach()), float(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert float(tmet["tokens"]) == B * seq - 3
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(jleaves) == len(tg)
    for (path, want), got in zip(jleaves, tg):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_vlm_masks_patch_positions():
    """As ``tests/test_models.py::test_vlm_masks_patch_positions``: at S =
    64 positions, of which P are patches, the loss counts B x (S - P)
    tokens."""
    s = 64
    cfg = tget(ARCH).reduced()
    tm = TModel(cfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    toks = rng.randint(0, cfg.vocab_size, (B, s - cfg.num_patches + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:]),
             "patches": torch.from_numpy(_patches(cfg))}
    with torch.no_grad():
        loss, metrics = tm.train_loss(tp, batch)
    assert torch.isfinite(loss)
    assert int(metrics["tokens"]) == B * (s - cfg.num_patches)


def test_params_from_numpy_keeps_dense_checks():
    jm = JModel(jget(ARCH).reduced())
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tree["layers"]["attn"]["w_q"] = tree["layers"]["attn"]["w_q"][..., :-4]
    with pytest.raises(ValueError, match="layers.attn.w_q"):
        params_from_numpy(tree, tget(ARCH).reduced(), device="cpu")


class PatchData:
    """Token batches of a ``SyntheticTokens`` with seeded patch
    embeddings (a normal x 0.02) under ``patches``: numpy arrays, as
    both packages' Trainers take them."""

    def __init__(self, tokens, num_patches, d_model, seed=0):
        self.tokens, self.seed = tokens, seed
        self.shape = (tokens.batch, num_patches, d_model)

    def get(self, step):
        batch = dict(self.tokens.get(step))
        rng = np.random.RandomState(self.seed + step)
        batch["patches"] = (0.02 * rng.standard_normal(self.shape)).astype(
            np.float32)
        return batch


def test_trainer_steps_with_patches_match_reference():
    """Two Trainer steps from the same weights on the flash route (8 + 32
    positions > the lowered threshold), both packages fed by one data
    object whose batches carry ``patches``: each step's losses, accuracy
    and token count (B x 32) equal the reference Trainer's."""
    jm, jp, tm, tp = _pair(attn_flash_min_seq=8)
    oc_kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    joc, toc = JOpt(**oc_kw), OptimizerConfig(**oc_kw)
    data_kw = dict(batch=2, seq=32, seed=3, mode="markov")
    cfg = jm.cfg
    jtr = JTrainer(jm, joc, PatchData(JTokens(cfg.vocab_size, **data_kw),
                                      cfg.num_patches, cfg.d_model),
                   JTrainerConfig())
    jtr.start_step = 0
    jtr.run({"params": jp, "opt": jinit(jp, joc)}, 2)
    ttr = Trainer(tm, toc, PatchData(SyntheticTokens(cfg.vocab_size,
                                                     **data_kw),
                                     cfg.num_patches, cfg.d_model),
                  TrainerConfig())
    ttr.start_step = 0
    ttr.run({"params": tp, "opt": init_opt_state(tp, toc)}, 2)
    assert len(ttr.history) == len(jtr.history) == 2
    for th, jh in zip(ttr.history, jtr.history):
        assert th["tokens"] == 2 * 32
        for k in ("ce_loss", "loss", "accuracy", "tokens"):
            np.testing.assert_allclose(th[k], float(jh[k]), rtol=1e-5,
                                       err_msg=k)
