"""The MoE family through the port's ``LanguageModel`` against the
reference's no-mesh model (CPU, fp32), on reduced arctic-480b (MoE +
dense residual) and reduced deepseek-v2-236b without MLA (two shared
experts, ``first_k_dense`` 1): weights made by the JAX init and carried
across with ``params_from_numpy`` give the reference's prefill logits,
``"dense"`` / ``"layers"`` caches and decode logits; ``train_loss``, its
MoE metrics and its gradients match ``jax.grad``; three ``Trainer``
steps with drops (capacity factor 1.0) stamp the reference ``Trainer``'s
dispatch gauges; deepseek with its MLA builds the reference's init tree
(``tests/test_torch_mla_model.py`` holds the MLA model itself).

Tolerances as ``test_torch_model.py`` (logits 1e-4) and
``test_torch_train.py`` (metrics 1e-6 relative, gradients 1e-5 of each
leaf's largest entry)."""
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
ARCHS = {"arctic": ("arctic-480b", {}),
         "deepseek": ("deepseek-v2-236b", {"use_mla": False})}


def _pair(name, **over):
    arch, base = ARCHS[name]
    jcfg = dataclasses.replace(jget(arch).reduced(), **base, **over)
    tcfg = dataclasses.replace(tget(arch).reduced(), **base, **over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    return jm, jp, TModel(tcfg, device="cpu"), tp


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("name,seq,over", [
    ("arctic", 12, {}),
    ("deepseek", 12, {}),
    ("arctic", 40, {"attn_flash_min_seq": 8, "capacity_factor": 1.0}),
    ("deepseek", 40, {"attn_flash_min_seq": 8, "capacity_factor": 1.0}),
])
def test_prefill_and_decode_match_reference(name, seq, over):
    jm, jp, tm, tp = _pair(name, **over)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jm.cfg.vocab_size, (2, seq)).astype(np.int32)
    jlog, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()})
    _close(tlog, jlog)
    assert set(tcache) == set(jcache) == (
        {"dense", "layers"} if name == "deepseek" else {"layers"})
    for part in tcache:
        for kv in ("k", "v"):
            _close(tcache[part][kv], jcache[part][kv])

    jcache = jax.tree_util.tree_map(
        lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, STEPS), (0, 0)]),
        jcache)
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
        _close(tcache[part]["k"], jcache[part]["k"])


def _batch(vocab, b=2, s=40, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    batch["targets"][0, :3] = -1                   # masked targets
    return batch


@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("name", ["arctic", "deepseek"])
def test_loss_and_grads_match_reference(name, cf):
    jm, jp, tm, tp = _pair(name, attn_flash_min_seq=8, capacity_factor=cf)
    batch = _batch(jm.cfg.vocab_size)
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
    assert float(tmet["aux_loss"].detach()) > 0
    if cf == 1.0:
        assert float(tmet["moe_dropped_tokens"]) > 0
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(jleaves) == len(tg)
    for (path, want), got in zip(jleaves, tg):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["arctic", "deepseek"])
def test_trainer_moe_gauges_match_reference(name):
    """Three Trainer steps from the same weights at capacity factor 1.0
    (tokens dropped): each step's ``moe_dropped_tokens`` and
    ``moe_overflow_rate`` and the runtime's stats equal the reference
    Trainer's."""
    jm, jp, tm, tp = _pair(name, capacity_factor=1.0)
    oc_kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                 state_dtype=jm.cfg.optimizer_state_dtype)
    joc, toc = JOpt(**oc_kw), OptimizerConfig(**oc_kw)
    data_kw = dict(batch=4, seq=16, seed=3, mode="markov")
    jtr = JTrainer(jm, joc, JTokens(jm.cfg.vocab_size, **data_kw),
                   JTrainerConfig())
    jtr.start_step = 0
    jtr.run({"params": jp, "opt": jinit(jp, joc)}, STEPS)
    ttr = Trainer(tm, toc, SyntheticTokens(tm.cfg.vocab_size, **data_kw),
                  TrainerConfig())
    ttr.start_step = 0
    ttr.run({"params": tp, "opt": init_opt_state(tp, toc)}, STEPS)
    assert len(ttr.history) == len(jtr.history) == STEPS
    for th, jh in zip(ttr.history, jtr.history):
        assert th["moe_dropped_tokens"] == float(jh["moe_dropped_tokens"])
        np.testing.assert_allclose(th["moe_overflow_rate"],
                                   float(jh["moe_overflow_rate"]), rtol=1e-6)
        np.testing.assert_allclose(th["ce_loss"], float(jh["ce_loss"]),
                                   rtol=1e-5)
    assert any(h["moe_dropped_tokens"] > 0 for h in ttr.history)
    ts, js = ttr.last_runtime_stats, jtr.last_runtime_stats
    assert ts.moe_dropped_tokens == js.moe_dropped_tokens > 0
    assert ts.moe_overflow_rate == pytest.approx(js.moe_overflow_rate,
                                                 rel=1e-6)
    assert ts.moe_a2a_bytes == js.moe_a2a_bytes == 0


def _init_layouts(jcfg, tcfg):
    """(port init tree shapes, reference init tree shapes)."""
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = TModel(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    want = {jax.tree_util.keystr(p): tuple(np.shape(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {"".join(f"['{k}']" for k in path): tuple(x.shape)
           for path, x in iter_leaves(tp)}
    return got, want


def test_init_layout_and_mla_layout():
    """``init`` gives the reference's tree (``dense_layers`` for
    ``first_k_dense``) in the config's dtypes, with int8 moments for
    arctic's optimizer; deepseek with its MLA gives the reference's MLA
    tree (``attn.w_uq`` and no ``attn.w_q`` in both stacks, the dense
    layer's MLP at 8 × d_ff)."""
    for name in ARCHS:
        jm, _jp, tm, _tp = _pair(name)
        got, want = _init_layouts(jm.cfg, tm.cfg)
        assert got == want
    cfg = tget("arctic-480b")
    assert cfg.param_dtype == "bfloat16" and \
        cfg.optimizer_state_dtype == "int8"
    got, want = _init_layouts(jget("deepseek-v2-236b").reduced(),
                              tget("deepseek-v2-236b").reduced())
    assert got == want
    for stack in ("dense_layers", "layers"):
        assert f"['{stack}']['attn']['w_uq']" in got
        assert f"['{stack}']['attn']['w_q']" not in got
    assert got["['dense_layers']['mlp']['w_gate']"] == (1, 128, 2048)
