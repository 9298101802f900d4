"""The port's training slice against the JAX package (CPU, fp32):

* one training step of reduced llama3.2-3b and h2o-danube3-4b (sliding
  window) through the flash branch (``attn_flash_min_seq=8``, seq 40):
  loss, metrics and gradients against ``jax.value_and_grad`` of the
  reference's ``train_loss``, and the updated state of a whole train step
  (one with ``accum_steps=2``) against the reference's step, for those
  two and for reduced mamba2-1.3b (ssm) and zamba2-1.2b (hybrid; its
  shared attention block applied twice);
* a mirror of ``tests/test_system.py`` through the port's ``Trainer``:
  train, checkpoint, restore, greedy decode that follows the chain;
* fail-stop restart bit-exact, as ``tests/test_trainer.py``;
* checkpoints that cross between the frameworks in both directions.

Tolerances (fp32, the same arithmetic in another summation order):
loss and metrics 1e-6 relative (10x that for the reduced zamba2, see
``CONDITIONING``); gradients 1e-5 of each leaf's largest
entry; logits of restored models 1e-4 (as ``test_torch_model.py``).
One AdamW step moves a parameter by about lr·sign(g) (m/√v ≈ ±1 at step
1), so an entry whose gradient is within rounding of zero may move by
up to 2·lr in one framework and not the other: parameters after a step
are held to 2·lr elementwise and to 1e-5·lr on average (a few entries
per leaf differ by ~1e-2·lr, the mean by ~5e-7·lr; 1e-4·lr for the
reduced zamba2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.configs import get_config as jget
from repro.data import SyntheticTokens as JTokens
from repro.models.model import LanguageModel as JModel
from repro.optim import OptimizerConfig as JOpt
from repro.train.steps import make_train_step as jmake_step
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import ckpt as tckpt
from repro_torch.configs import get_config as tget
from repro_torch.convert import (params_from_numpy, state_from_numpy,
                                 state_to_numpy)
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models.model import LanguageModel as TModel
from repro_torch.optim import OptimizerConfig
from repro_torch.optim.adamw import init_opt_state, iter_leaves
from repro_torch.train.steps import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

FLASH = {"attn_flash_min_seq": 8}        # seq 40 > 32: the flash branch
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=20)


def _pair(arch, **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    tcfg = dataclasses.replace(tget(arch).reduced(), **over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    return jm, jp, TModel(tcfg, device="cpu"), tp


def _batch(vocab, b=2, s=40, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    batch["targets"][0, :3] = -1                   # masked targets
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jleaves(tree):
    """(path tuple, numpy leaf) of a JAX dict pytree, sorted-key order."""
    return [(tuple(p.key for p in path), np.asarray(x))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _metrics_close(tm, jm, rtol=1e-6):
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k].detach()), float(v),
                                   rtol=rtol, atol=1e-7, err_msg=k)


# The reduced zamba2 is ill-conditioned in fp32: a one-ulp nudge of its
# weights moves its gradients by ~2e-5 of a leaf's largest entry, ~8x
# the dense configs' and mamba2's (2-4e-6), so the two frameworks'
# gradients differ by ~1e-5 there, its grad_norm by ~1.5e-6, and AdamW's
# first step (g / |g|) spreads that into the mean update: its metric and
# mean-update limits are this factor times the others'.
CONDITIONING = {"zamba2-1.2b": 10}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "h2o-danube-3-4b"])
def test_loss_and_grads_match_reference(arch, monkeypatch):
    jm, jp, tm, tp = _pair(arch, **FLASH)
    plain_calls = []
    bwd = tfa.flash_attention_bwd_plain
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain",
                        lambda *a, **k: plain_calls.append(1) or bwd(*a, **k))
    batch = _batch(jm.cfg.vocab_size)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True))(
        jp, _jb(batch))
    leaves = [x.requires_grad_() for _p, x in iter_leaves(tp)]
    tl, tmet = tm.train_loss(tp, _tb(batch))
    tg = torch.autograd.grad(tl, leaves)
    assert len(plain_calls) == tm.cfg.num_layers     # flash backward ran
    _metrics_close(tmet, jmet)
    for (path, want), got in zip(_jleaves(jg), tg):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg="/".join(path))


def _params_close(tparams, jparams, lr, mean=1e-5):
    for (path, want), (_q, got) in zip(_jleaves(jparams),
                                       iter_leaves(tparams)):
        diff = np.abs(got.detach().numpy() - want)
        assert diff.max() <= 2 * lr, path
        assert diff.mean() <= mean * lr, path


@pytest.mark.parametrize("arch,accum", [("h2o-danube-3-4b", 1),
                                        ("llama3.2-3b", 2),
                                        ("mamba2-1.3b", 1),
                                        ("zamba2-1.2b", 1)])
def test_train_step_matches_reference(arch, accum):
    jm, jp, tm, tp = _pair(arch, **FLASH)
    batch = _batch(jm.cfg.vocab_size, b=4)
    joc, toc = JOpt(accum_steps=accum, **OPT), OptimizerConfig(
        accum_steps=accum, **OPT)
    from repro.optim import init_opt_state as jinit
    jstate = {"params": jp, "opt": jinit(jp, joc)}
    tstate = {"params": tp, "opt": init_opt_state(tp, toc)}
    jstate, jmet = jax.jit(jmake_step(jm, joc))(jstate, _jb(batch))
    tstate, tmet = make_train_step(tm, toc)(tstate, _tb(batch))
    k = CONDITIONING.get(arch, 1)
    _metrics_close(tmet, jmet, k * 1e-6)
    assert int(tstate["opt"]["step"]) == 1
    _params_close(tstate["params"], jstate["params"], OPT["peak_lr"],
                  k * 1e-5)


def test_remat_modes_give_the_same_gradients():
    _jm, _jp, tm, tp = _pair("smollm-360m", **FLASH)
    batch = _tb(_batch(tm.cfg.vocab_size))
    grads = {}
    for remat in ("none", "layer", "dots"):
        m = TModel(dataclasses.replace(tm.cfg, remat=remat), device="cpu")
        leaves = [x.detach().requires_grad_() for _p, x in iter_leaves(tp)]
        params = _unflat(tp, leaves)
        loss, _ = m.train_loss(params, batch)
        grads[remat] = torch.autograd.grad(loss, leaves)
    for remat in ("layer", "dots"):
        for a, b in zip(grads["none"], grads[remat]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _unflat(tree, leaves):
    it = iter(leaves)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}
    return build(tree)


# ----------------------------------------------- trainer, checkpoints, serve

def test_train_checkpoint_serve_roundtrip(tmp_path):
    """Mirror of tests/test_system.py through the port."""
    cfg = tget("llama3.2-3b").reduced()
    model = TModel(cfg, device="cpu")
    oc = OptimizerConfig(peak_lr=5e-3, warmup_steps=10, total_steps=400,
                         weight_decay=0.0)
    data = SyntheticTokens(cfg.vocab_size, batch=16, seq=32, seed=11,
                           mode="markov")
    tr = Trainer(model, oc, data, TrainerConfig(
        ckpt_dir=str(tmp_path), ckpt_every=20, async_ckpt=False))
    state = tr.init_or_restore(torch.Generator().manual_seed(0))
    tr.run(state, 60)

    losses = [h["ce_loss"] for h in tr.history]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses
    assert [h["step"] for h in tr.history] == list(range(60))
    assert tr.registry.value("train.steps") == 60
    assert tr.registry.value("train.step") == 59.0

    tree, step = tckpt.restore(str(tmp_path))
    assert step == 60
    params = state_from_numpy(tree["params"], "cpu")
    tokens = torch.tensor([[7, (7 * 31 + 7) % cfg.vocab_size]])
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens})
        want = (int(tokens[0, -1]) * 31 + 7) % cfg.vocab_size
        assert want in torch.topk(logits[0], 5).indices.tolist()
        cache = model.alloc_cache(1, tokens.shape[1] + 4, init=cache)
        tok, hits = torch.tensor([[want]]), 0
        for i in range(2):
            logits, cache = model.decode_step(params, cache, tok,
                                              tokens.shape[1] + i)
            want_i = (int(tok[0, 0]) * 31 + 7) % cfg.vocab_size
            hits += want_i in torch.topk(logits[0], 5).indices.tolist()
            tok = torch.tensor([[want_i]])
    assert hits >= 1


@pytest.fixture(scope="module")
def smollm():
    cfg = tget("smollm-360m").reduced()
    oc = OptimizerConfig(peak_lr=1e-3, warmup_steps=5, total_steps=60)
    data = SyntheticTokens(cfg.vocab_size, batch=4, seq=32, seed=7,
                           mode="markov")
    return TModel(cfg, device="cpu"), oc, data


def test_failure_restart_bit_exact(smollm, tmp_path):
    """Fail-stop at step 8, restart from the step-5 manifest, finish: the
    final params equal an uninterrupted run's bit for bit."""
    model, oc, data = smollm
    tr_a = Trainer(model, oc, data, TrainerConfig())
    state_a = tr_a.run(tr_a.init_or_restore(torch.Generator().manual_seed(0)),
                       12)

    tc = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5,
                       async_ckpt=False, fail_at_step=8)
    tr_b = Trainer(model, oc, data, tc)
    tr_b.run(tr_b.init_or_restore(torch.Generator().manual_seed(0)), 12)
    assert max(h["step"] for h in tr_b.history) == 7     # died at 8

    tr_c = Trainer(model, oc, data, TrainerConfig(
        ckpt_dir=str(tmp_path), ckpt_every=5, async_ckpt=False))
    state_c = tr_c.init_or_restore(torch.Generator().manual_seed(99))
    assert tr_c.start_step == 5
    state_c = tr_c.run(state_c, 12 - tr_c.start_step)
    for (_p, a), (_q, b) in zip(iter_leaves(state_a), iter_leaves(state_c)):
        assert torch.equal(a, b)


def _jax_logits(cfg, params, tokens):
    logits, _ = jax.jit(JModel(cfg).prefill)(
        params, {"tokens": jnp.asarray(tokens)})
    return np.asarray(logits)


@pytest.mark.parametrize("arch", ["smollm-360m", "arctic-480b"])
def test_checkpoints_cross_between_frameworks(tmp_path, arch):
    """A JAX Trainer checkpoint restores into the port with the JAX
    logits; a port Trainer checkpoint restores into the JAX model with the
    port's logits.  Reduced arctic-480b carries MoE trees and its int8
    AdamW moments across."""
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    tokens = np.random.RandomState(3).randint(0, jcfg.vocab_size, (2, 12))
    oc_kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10,
                 state_dtype=jcfg.optimizer_state_dtype)
    tc_kw = dict(ckpt_every=2, async_ckpt=False)

    jdir = tmp_path / "jax"
    jtr = JTrainer(JModel(jcfg), JOpt(**oc_kw),
                   JTokens(jcfg.vocab_size, 2, 16, seed=5, mode="markov"),
                   JTrainerConfig(ckpt_dir=str(jdir), **tc_kw))
    jstate = jtr.run(jtr.init_or_restore(jax.random.PRNGKey(0)), 2)
    tr = Trainer(TModel(tcfg, device="cpu"), OptimizerConfig(**oc_kw),
                 SyntheticTokens(tcfg.vocab_size, 2, 16, seed=5,
                                 mode="markov"),
                 TrainerConfig(ckpt_dir=str(jdir), **tc_kw))
    state = tr.init_or_restore(torch.Generator().manual_seed(1))
    assert tr.start_step == 2
    assert int(state["opt"]["step"]) == 2
    with torch.no_grad():
        got, _ = tr.model.prefill(state["params"],
                                  {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(),
                               _jax_logits(jcfg, jstate["params"], tokens),
                               atol=1e-4, rtol=1e-4)

    tdir = tmp_path / "torch"
    tr2 = Trainer(TModel(tcfg, device="cpu"), OptimizerConfig(**oc_kw),
                  SyntheticTokens(tcfg.vocab_size, 2, 16, seed=5,
                                  mode="markov"),
                  TrainerConfig(ckpt_dir=str(tdir), **tc_kw))
    tstate = tr2.run(tr2.init_or_restore(torch.Generator().manual_seed(1)),
                     2)
    tree, step = jckpt.restore(str(tdir))
    assert step == 2
    host = state_to_numpy(tstate)
    if arch == "arctic-480b":
        assert host["params"]["layers"]["moe"]["w_gate"].ndim == 4
        assert host["opt"]["m"]["layers"]["moe"]["w_gate"]["q"].dtype == \
            np.int8
    for (path, want), (_q, got) in zip(_jleaves(tree), iter_leaves(host)):
        assert want.dtype == got.dtype and np.array_equal(want, got), path
    with torch.no_grad():
        want, _ = tr2.model.prefill(tstate["params"],
                                    {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(
        _jax_logits(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                 tree["params"]), tokens),
        want.numpy(), atol=1e-4, rtol=1e-4)


def test_multi_device_requests_and_unsaved_dtypes_raise():
    """Multi-device requests the port cannot serve raise: ``--tp > 1``
    outside a rank process (no mesh to train on) and a mesh run without
    a named backend; a Trainer that saves under a mesh is built (the
    sharded save itself runs in ``tests/test_torch_ckpt_sharded.py``);
    train-state leaves of a dtype the checkpoints do not carry (bf16
    would need ml_dtypes on the host) raise."""
    from repro_torch.launch import train as train_cli
    with pytest.raises(ValueError, match="mesh"):
        train_cli.run(train_cli.parse_args(["--smoke", "--device", "cpu",
                                            "--tp", "2"]))
    with pytest.raises(SystemExit):
        train_cli.main(["--smoke", "--device", "cpu", "--tp", "2"])
    model = TModel(tget("smollm-360m").reduced(), device="cpu")
    mesh = object()
    tr = Trainer(model, OptimizerConfig(), None,
                 TrainerConfig(ckpt_dir="unused", ckpt_every=1), mesh=mesh)
    assert tr.mesh is mesh and tr.tc.ckpt_every == 1
    with pytest.raises(TypeError):
        state_from_numpy({"w": np.zeros(2, np.float16)}, "cpu")
    with pytest.raises(TypeError):
        state_to_numpy({"w": torch.zeros(2, dtype=torch.bfloat16)})
