"""deepseek-v2-236b with MLA through the port's ``LanguageModel`` against
the reference's no-mesh model (CPU, fp32), on the reduced config (q/k
16 + 16, v 32) and a variant with q/k 32 + 16 = 48 and v 32, each at a
sequence below ``flash_min_seq`` (12: the dense attention) and above it
(40 with ``attn_flash_min_seq`` 8: the flash kernels' path, at hd 32 /
hd_v 32 or hd 48 / hd_v 32): weights made by the JAX init and carried
across with ``params_from_numpy`` give the reference's ``init`` tree,
prefill logits, latent caches (``"dense"`` and ``"layers"``) and decode
logits; ``train_loss`` and its gradients match ``jax.grad``; three
``Trainer`` steps with the config's int8 moments and its four
accumulated micro-batches give the reference ``Trainer``'s losses; the
dense first layer's MLP is 8 × d_ff wide (2048; 12288 at full width);
``launch.train`` trains and resumes the reduced config with the
config's accumulation.

Tolerances as ``test_torch_moe_model.py``: logits 1e-4, metrics 1e-6
relative, gradients 1e-5 of each leaf's largest entry, Trainer losses
1e-5."""
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

ATOL = 1e-4      # logits: fp32 through a few layers, summation order only
STEPS = 3
ARCH = "deepseek-v2-236b"
VARIANTS = {"reduced": {},
            "hd48": {"qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
                     "v_head_dim": 32}}
# (sequence, overrides): below the default threshold (dense attention)
# and above a lowered one (the flash kernels)
SEQS = {"dense": (12, {}), "flash": (40, {"attn_flash_min_seq": 8})}


def _pair(variant, **over):
    over = {**VARIANTS[variant], **over}
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


def _shapes(tree):
    return {"".join(f"['{k}']" for k in path): tuple(x.shape)
            for path, x in iter_leaves(tree)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_tree_and_dense_width(variant):
    """``init`` gives the reference's tree (MLA leaves in both stacks,
    ``dense_layers`` with the 8 × d_ff MLP) and the full config builds
    without raising, its dense layers at 12288."""
    jm, jp, tm, tp = _pair(variant)
    got = _shapes(tm.init(torch.Generator().manual_seed(0)))
    want = {jax.tree_util.keystr(p): tuple(np.shape(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert got == want == _shapes(tp)
    cfg = tm.cfg
    dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    for stack in ("dense_layers", "layers"):
        assert tp[stack]["attn"]["w_uq"].shape[-2:] == (cfg.num_heads, dqk)
        assert "w_q" not in tp[stack]["attn"]
    assert tp["dense_layers"]["mlp"]["w_gate"].shape == (1, 128, 2048)
    assert tm._dense_cfg.d_ff == jm._dense_cfg.d_ff == 2048
    full = TModel(tget(ARCH), device="cpu")
    assert full._dense_cfg.d_ff == 12288 and full._kind == "mla_moe"
    assert full._dense_kind == "mla_dense"


def test_params_from_numpy_checks_mla_leaves():
    """``params_from_numpy`` checks ``attn.w_uq`` and ``attn.w_dkv`` of
    both stacks under MLA: a tree of another width raises."""
    jm, jp, _tm, _tp = _pair("reduced")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    for stack, leaf in (("layers", "w_uq"), ("dense_layers", "w_dkv")):
        bad = jax.tree_util.tree_map(lambda a: a, tree)
        bad[stack]["attn"][leaf] = bad[stack]["attn"][leaf][..., :-8]
        with pytest.raises(ValueError, match=f"{stack}.attn.{leaf}"):
            params_from_numpy(bad, tget(ARCH).reduced(), device="cpu")
    with pytest.raises(ValueError, match="w_uq"):
        params_from_numpy(tree, dataclasses.replace(
            tget(ARCH).reduced(), **VARIANTS["hd48"]), device="cpu")


@pytest.mark.parametrize("route", list(SEQS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_reference(variant, route):
    seq, over = SEQS[route]
    jm, jp, tm, tp = _pair(variant, **over)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jm.cfg.vocab_size, (2, seq)).astype(np.int32)
    jlog, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()})
    _close(tlog, jlog)
    assert set(tcache) == set(jcache) == {"dense", "layers"}
    for part in tcache:
        assert set(tcache[part]) == {"c_kv", "k_rope"}
        for name in tcache[part]:
            _close(tcache[part][name], jcache[part][name])

    jcache = jax.tree_util.tree_map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, STEPS), (0, 0)]), jcache)
    tcache = tm.alloc_cache(2, seq + STEPS, init=tcache)
    spec = jm.cache_spec(2, seq + STEPS)
    assert {p: {k: tuple(v.shape) for k, v in c.items()}
            for p, c in tcache.items()} == \
        {p: {k: v.shape for k, v in c.items()} for p, c in spec.items()}
    jstep = jax.jit(jm.decode_step)
    for i in range(STEPS):
        tok = rng.randint(0, jm.cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = jstep(jp, jcache, jnp.asarray(tok),
                             jnp.asarray(seq + i, jnp.int32))
        tlog, tcache = tm.decode_step(tp, tcache,
                                      torch.from_numpy(tok).long(), seq + i)
        _close(tlog, jlog)
    for part in tcache:
        for name in ("c_kv", "k_rope"):
            _close(tcache[part][name], jcache[part][name])


def _batch(vocab, b=2, s=40, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    batch["targets"][0, :3] = -1                   # masked targets
    return batch


@pytest.mark.parametrize("route", list(SEQS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_reference(variant, route):
    seq, over = SEQS[route]
    jm, jp, tm, tp = _pair(variant, **over)
    batch = _batch(jm.cfg.vocab_size, s=seq)
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
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(jleaves) == len(tg)
    for (path, want), got in zip(jleaves, tg):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_trainer_steps_match_reference(variant):
    """Three Trainer steps from the same weights, with the config's int8
    moments and its ``train_accum_steps`` (4) micro-batches of 1 × 40 (the
    flash path): each step's losses equal the reference Trainer's."""
    jm, jp, tm, tp = _pair(variant, attn_flash_min_seq=8)
    assert tm.cfg.optimizer_state_dtype == "int8"
    oc_kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                 state_dtype=jm.cfg.optimizer_state_dtype,
                 accum_steps=jm.cfg.train_accum_steps)
    assert oc_kw["accum_steps"] == 4
    joc, toc = JOpt(**oc_kw), OptimizerConfig(**oc_kw)
    data_kw = dict(batch=4, seq=40, seed=3, mode="markov")
    jtr = JTrainer(jm, joc, JTokens(jm.cfg.vocab_size, **data_kw),
                   JTrainerConfig())
    jtr.start_step = 0
    jtr.run({"params": jp, "opt": jinit(jp, joc)}, STEPS)
    ttr = Trainer(tm, toc, SyntheticTokens(tm.cfg.vocab_size, **data_kw),
                  TrainerConfig())
    ttr.start_step = 0
    state = ttr.run({"params": tp, "opt": init_opt_state(tp, toc)}, STEPS)
    assert state["opt"]["m"]["layers"]["attn"]["w_uq"]["q"].dtype == \
        torch.int8
    assert len(ttr.history) == len(jtr.history) == STEPS
    for th, jh in zip(ttr.history, jtr.history):
        for k in ("ce_loss", "loss", "aux_loss"):
            np.testing.assert_allclose(th[k], float(jh[k]), rtol=1e-5,
                                       err_msg=k)


def test_launch_train_runs_reduced_deepseek_with_its_accumulation(tmp_path):
    """``launch.train`` admits deepseek-v2-236b: the reduced config trains
    on the CPU with the config's int8 moments and 4 micro-batches a step,
    checkpoints, and resumes from the checkpoint."""
    from repro_torch.launch import train as train_cli

    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--data",
            "markov", "--batch", "4", "--seq", "16", "--steps", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    args = train_cli.parse_args(argv)
    oc = train_cli.optimizer_config(tget(ARCH).reduced(), args)
    assert (oc.accum_steps, oc.state_dtype) == (4, "int8")
    tr, state = train_cli.run(args)
    assert tr.oc.accum_steps == 4 and len(tr.history) == 2
    assert all(np.isfinite(h["ce_loss"]) for h in tr.history)
    assert state["opt"]["m"]["dense_layers"]["attn"]["w_uq"]["q"].dtype == \
        torch.int8
    tr2, _ = train_cli.run(train_cli.parse_args(argv[:-5] + [
        "3", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]))
    assert tr2.start_step == 2 and len(tr2.history) == 1
