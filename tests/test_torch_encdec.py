"""whisper-small (the encoder-decoder family) through the port against the
reference's no-mesh model on the CPU, reduced config (2 encoder + 2
decoder layers, d 128, 4 heads over 2 kv heads of 32, 24 frames).

Weights come from the JAX ``init``, every leaf moved by 0.1 of a seeded
normal draw (so the LayerNorm scales and every bias differ from their
init's ones and zeros), and are carried across with
``params_from_numpy``.  Inputs are numpy arrays from a seed.  One by one:
``layernorm``, ``gelu_mlp``, ``_sinusoid`` (bit-equal), the bf16
encoder, ``cross_attention``, ``enc_layer_apply`` and
``dec_layer_train`` / ``_prefill`` / ``_decode``; then the model: the
``init`` tree, prefill logits and every cache leaf, decode steps through
``alloc_cache(B, S + n, init=cache)``, ``train_loss`` and its gradients
against ``jax.value_and_grad``, and two ``Trainer`` steps against the
reference's ``Trainer`` on one data object whose ``get(i)`` carries
``frames`` (their losses: AdamW's normalized step turns a gradient
entry near zero into about ±lr whichever way it rounds, so parameters
are not compared), each at a sequence below ``flash_min_seq`` (12: the
dense attention) and above a lowered one (40 with
``attn_flash_min_seq`` 8: the flash kernels' path, their plain version
on the CPU).

Tolerances: fp32 with the summation order the only difference, values
O(1): one layer 1e-5, logits and caches through the model 1e-4, metrics
1e-6 relative, gradients 1e-5 of each leaf's largest entry, Trainer
losses 1e-5.  The bf16 encoder: 2 bf16 ulps (2^-7) of the largest output
entry, as each side rounds its own fp32 sums once a product.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import SyntheticTokens as JTokens
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.optim import OptimizerConfig as JOpt
from repro.optim import init_opt_state as jinit
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.data import SyntheticTokens
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.model import layer_params
from repro_torch.optim import OptimizerConfig
from repro_torch.optim.adamw import init_opt_state, iter_leaves
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "whisper-small"
ATOL = 1e-4       # logits and caches through the model
LAYER_TOL = 1e-5  # one layer
STEPS = 3
B = 2
# (sequence, overrides): below the default threshold (dense attention)
# and above a lowered one (the flash kernels' plain version)
SEQS = {"dense": (12, {}), "flash": (40, {"attn_flash_min_seq": 8})}


def _perturb(tree, seed):
    """Every leaf plus 0.1 x a seeded normal draw, as numpy fp32."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.1 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), tree)


def _pair(**over):
    jcfg = dataclasses.replace(jget(ARCH).reduced(), **over)
    tcfg = dataclasses.replace(tget(ARCH).reduced(), **over)
    jm = jmodel.LanguageModel(jcfg)
    host = _perturb(jm.init(jax.random.PRNGKey(0)), 5)
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    tp = params_from_numpy(host, tcfg, device="cpu")
    return jm, jp, tmodel.LanguageModel(tcfg, device="cpu"), tp


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _frames(cfg, b=B, seed=7):
    """Frame embeddings drawn as ``tests/test_models.py`` draws them
    (a normal x 0.02), from numpy."""
    rng = np.random.RandomState(seed)
    return (0.02 * rng.standard_normal(
        (b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)


def _x(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _layer(jp, tp, stack, i=0):
    return (jax.tree_util.tree_map(lambda a: a[i], jp[stack]),
            layer_params(tp[stack], i))


# --------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """Population variance, scale and bias in fp32; bf16 input comes back
    bf16 within one ulp (each side's fp32 mean and variance may round
    the last bit differently)."""
    d = 128
    p = {"scale": 1 + 0.1 * _x((d,), 1), "bias": 0.1 * _x((d,), 2)}
    x = 3.0 + 2.0 * _x((2, 12, d), 3)     # a mean far from 0
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jlayers.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x).astype(jdt), 1e-5)
    got = tlayers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x).to(tdt), 1e-5)
    assert got.dtype == tdt
    tol = LAYER_TOL if dtype == "float32" else 2.0 ** -7
    _close(got, np.asarray(want.astype(jnp.float32)), tol)


def test_layernorm_init_matches_reference():
    want = jlayers.layernorm_init(64, jnp.float32)
    got = tlayers.layernorm_init(64, torch.float32, "cpu")
    assert set(got) == set(want) == {"scale", "bias"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    """The tanh GELU in fp32, biases in the input's dtype."""
    d, f = 128, 256
    p = {"w_in": _x((d, f), 1) / np.sqrt(d), "b_in": 0.5 * _x((f,), 2),
         "w_out": _x((f, d), 3) / np.sqrt(f), "b_out": 0.5 * _x((d,), 4)}
    x = _x((2, 12, d), 5)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jlayers.gelu_mlp({k: jnp.asarray(v).astype(jdt)
                             for k, v in p.items()},
                            jnp.asarray(x).astype(jdt))
    got = tlayers.gelu_mlp({k: torch.from_numpy(v).to(tdt)
                            for k, v in p.items()},
                           torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    tol = LAYER_TOL if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
    _close(got, want, tol)


def test_gelu_mlp_init_layout():
    got = tlayers.gelu_mlp_init(torch.Generator().manual_seed(0), 16, 48,
                                torch.float32)
    want = jlayers.gelu_mlp_init(jax.random.PRNGKey(0), 16, 48, jnp.float32)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert not got["b_in"].any() and not got["b_out"].any()


@pytest.mark.parametrize("seq,dim", [(24, 128), (1504, 768), (7, 10)])
def test_sinusoid_is_bit_equal(seq, dim):
    got = tmodel._sinusoid(seq, dim)
    want = jmodel._sinusoid(seq, dim)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_bf16_encoder_matches_reference():
    """The encoder in bf16 compute (fp32 weights cast per layer): frames
    and the sinusoid each cast to bf16 before they are added, then the
    layers and ``enc_norm``, against the reference's own steps."""
    jm, jp, tm, tp = _pair(dtype="bfloat16")
    cfg = jm.cfg
    frames = _frames(cfg)
    e = jnp.asarray(frames).astype(jnp.bfloat16) + jnp.asarray(
        jmodel._sinusoid(cfg.encoder_seq, cfg.d_model))[None].astype(
        jnp.bfloat16)
    for i in range(cfg.num_encoder_layers):
        e = jblocks.enc_layer_apply(
            jax.tree_util.tree_map(lambda a: a[i], jp["enc_layers"]), e, cfg)
    want = np.asarray(jlayers.layernorm(jp["enc_norm"], e, cfg.norm_eps)
                      .astype(jnp.float32))
    got = tm._encode(tp, torch.from_numpy(frames), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2.0 ** -7 * np.abs(want).max())


def test_cross_attention_matches_reference():
    jm, jp, tm, tp = _pair()
    jl, tl = _layer(jp, tp, "dec_layers")
    x, enc = _x((B, 12, 128), 1), _x((B, 24, 128), 2)
    want = jattn.cross_attention(jl["cross"], jnp.asarray(x),
                                 jnp.asarray(enc))
    got = tattn.cross_attention(tl["cross"], torch.from_numpy(x),
                                torch.from_numpy(enc))
    _close(got, want, LAYER_TOL)


def test_cross_attn_init_layout():
    cfg = tget(ARCH).reduced()
    got = tattn.cross_attn_init(torch.Generator().manual_seed(0), cfg)
    want = jattn.cross_attn_init(jax.random.PRNGKey(0), jget(ARCH).reduced())
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


def test_enc_layer_apply_matches_reference():
    jm, jp, tm, tp = _pair()
    jl, tl = _layer(jp, tp, "enc_layers", 1)
    x = _x((B, 24, 128), 3)
    want = jblocks.enc_layer_apply(jl, jnp.asarray(x), jm.cfg)
    got = tblocks.enc_layer_apply(tl, torch.from_numpy(x), tm.cfg)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("route", list(SEQS))
def test_dec_layer_train_prefill_decode_match_reference(route):
    """One decoder layer: train and prefill outputs, prefill's caches
    (head-major self k / v with KH heads, seq-major cross k / v with H),
    then STEPS decode steps into the padded caches."""
    seq, over = SEQS[route]
    jm, jp, tm, tp = _pair(**over)
    jl, tl = _layer(jp, tp, "dec_layers", 1)
    cfg = jm.cfg
    x, enc = _x((B, seq, 128), 4), _x((B, 24, 128), 5)
    pos_j = jnp.arange(seq)[None, :]
    pos_t = torch.arange(seq)[None, :]
    want = jblocks.dec_layer_train(jl, jnp.asarray(x), jnp.asarray(enc), cfg,
                                   pos_j)
    got = tblocks.dec_layer_train(tl, torch.from_numpy(x),
                                  torch.from_numpy(enc), tm.cfg, pos_t)
    _close(got, want, LAYER_TOL)
    want, jc = jblocks.dec_layer_prefill(jl, jnp.asarray(x), jnp.asarray(enc),
                                         cfg, pos_j)
    got, tc = tblocks.dec_layer_prefill(tl, torch.from_numpy(x),
                                        torch.from_numpy(enc), tm.cfg, pos_t)
    _close(got, want, LAYER_TOL)
    assert tuple(tc["k"].shape) == (B, cfg.num_kv_heads, seq, cfg.head_dim)
    assert tuple(tc["cross_k"].shape) == (B, 24, cfg.num_heads, cfg.head_dim)
    assert set(tc) == set(jc)
    for name in jc:
        _close(tc[name], jc[name], LAYER_TOL)
    pad = [(0, 0), (0, 0), (0, STEPS), (0, 0)]
    jc = {**jc, "k": jnp.pad(jc["k"], pad), "v": jnp.pad(jc["v"], pad)}
    tc = {**tc, "k": torch.from_numpy(np.array(jc["k"])),
          "v": torch.from_numpy(np.array(jc["v"]))}
    for i in range(STEPS):
        xt = _x((B, 1, 128), 10 + i)
        want, jc = jblocks.dec_layer_decode(jl, jnp.asarray(xt), cfg, jc,
                                            jnp.asarray(seq + i, jnp.int32))
        got, tc = tblocks.dec_layer_decode(tl, torch.from_numpy(xt), tm.cfg,
                                           tc, seq + i)
        _close(got, want, LAYER_TOL)
    for name in jc:
        _close(tc[name], jc[name], LAYER_TOL)


# ---------------------------------------------------------------- model


def test_init_tree_matches_reference():
    """``init`` gives the reference's tree: ``enc_layers``,
    ``dec_layers`` (attn, cross, three LayerNorms, the GELU MLP),
    ``enc_norm`` and a LayerNorm ``final_norm``, no ``layers``."""
    jm, jp, tm, tp = _pair()
    got = {"".join(f"['{k}']" for k in path): tuple(x.shape)
           for path, x in iter_leaves(tm.init(torch.Generator()
                                              .manual_seed(0)))}
    want = {jax.tree_util.keystr(p): tuple(np.shape(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert got == want
    assert "['final_norm']['bias']" in got and not any(
        k.startswith("['layers']") for k in got)


def test_params_from_numpy_converts_whole_tree():
    """A whole reference ``encdec`` tree converts with the same names,
    shapes and values."""
    jm, jp, tm, tp = _pair()
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = list(iter_leaves(tp))
    assert [jax.tree_util.keystr(p) for p, _ in want] == \
        ["".join(f"['{k}']" for k in p) for p, _ in got]
    for (_p, w), (_q, g) in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("path", [("enc_layers", "attn", "w_q"),
                                  ("dec_layers", "attn", "w_q"),
                                  ("dec_layers", "cross", "w_q"),
                                  ("dec_layers", "mlp", "w_in")])
def test_params_from_numpy_checks_encdec_leaves(path):
    jm = jmodel.LanguageModel(jget(ARCH).reduced())
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    node = tree
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = node[path[-1]][..., :-4]
    with pytest.raises(ValueError, match=".".join(path)):
        params_from_numpy(tree, tget(ARCH).reduced(), device="cpu")
    del node[path[-1]]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tree, tget(ARCH).reduced(), device="cpu")


@pytest.mark.parametrize("route", list(SEQS))
def test_prefill_and_decode_match_reference(route):
    """Prefill logits and every cache leaf against the reference's
    prefill; the self caches have KH heads, as the reference's prefill
    makes them (its ``cache_spec`` says H, which differs here); then
    ``alloc_cache(B, S + STEPS, init=cache)`` and STEPS decode steps."""
    seq, over = SEQS[route]
    jm, jp, tm, tp = _pair(**over)
    cfg = jm.cfg
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    frames = _frames(cfg)
    jlog, jcache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                                   "frames": torch.from_numpy(frames)})
    _close(tlog, jlog)
    assert set(tcache) == set(jcache) == {"layers"}
    assert set(tcache["layers"]) == set(jcache["layers"]) == \
        {"k", "v", "cross_k", "cross_v"}
    for name, leaf in jcache["layers"].items():
        assert tuple(tcache["layers"][name].shape) == leaf.shape
        _close(tcache["layers"][name], leaf)

    tcache = tm.alloc_cache(B, seq + STEPS, init=tcache)
    L, kh, h, hd = (cfg.num_layers, cfg.num_kv_heads, cfg.num_heads,
                    cfg.head_dim)
    assert {k: tuple(v.shape) for k, v in tcache["layers"].items()} == {
        "k": (L, B, kh, seq + STEPS, hd), "v": (L, B, kh, seq + STEPS, hd),
        "cross_k": (L, B, cfg.encoder_seq, h, hd),
        "cross_v": (L, B, cfg.encoder_seq, h, hd)}
    assert kh < h and jm.cache_spec(B, seq + STEPS)["layers"]["k"].shape[2] \
        == h
    pad = [(0, 0)] * 3 + [(0, STEPS), (0, 0)]
    jcache = {"layers": {**jcache["layers"],
                         "k": jnp.pad(jcache["layers"]["k"], pad),
                         "v": jnp.pad(jcache["layers"]["v"], pad)}}
    jstep = jax.jit(jm.decode_step)
    for i in range(STEPS):
        tok = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jlog, jcache = jstep(jp, jcache, jnp.asarray(tok),
                             jnp.asarray(seq + i, jnp.int32))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                      seq + i)
        _close(tlog, jlog)
    for name, leaf in jcache["layers"].items():
        _close(tcache["layers"][name], leaf)


def test_alloc_cache_without_init_is_zero():
    tm = tmodel.LanguageModel(tget(ARCH).reduced(), device="cpu")
    cache = tm.alloc_cache(3, 10)
    assert all(not x.any() for _p, x in iter_leaves(cache))
    assert cache["layers"]["cross_v"].shape == (2, 3, 24, 4, 32)


def _batch(cfg, s, b=B, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy(),
             "frames": _frames(cfg, b, seed + 1)}
    batch["targets"][0, :3] = -1                   # masked targets
    return batch


@pytest.mark.parametrize("route", list(SEQS))
def test_loss_and_grads_match_reference(route):
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
        assert np.abs(want).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))


class FramesData:
    """Token batches of a ``SyntheticTokens`` with seeded frame
    embeddings (a normal x 0.02) under ``frames``: numpy arrays, as both
    packages' Trainers take them."""

    def __init__(self, tokens, encoder_seq, d_model, seed=0):
        self.tokens, self.seed = tokens, seed
        self.shape = (tokens.batch, encoder_seq, d_model)

    def get(self, step):
        batch = dict(self.tokens.get(step))
        rng = np.random.RandomState(self.seed + step)
        batch["frames"] = (0.02 * rng.standard_normal(self.shape)).astype(
            np.float32)
        return batch


def test_trainer_steps_match_reference():
    """Two Trainer steps from the same weights on the flash route (1 x
    40 > the lowered threshold), both packages fed by one data object
    whose batches carry ``frames``: each step's losses, accuracy and
    token count equal the reference Trainer's."""
    jm, jp, tm, tp = _pair(attn_flash_min_seq=8)
    oc_kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    joc, toc = JOpt(**oc_kw), OptimizerConfig(**oc_kw)
    data_kw = dict(batch=2, seq=40, seed=3, mode="markov")
    cfg = jm.cfg
    jtr = JTrainer(jm, joc, FramesData(JTokens(cfg.vocab_size, **data_kw),
                                       cfg.encoder_seq, cfg.d_model),
                   JTrainerConfig())
    jtr.start_step = 0
    jstate = jtr.run({"params": jp, "opt": jinit(jp, joc)}, 2)
    ttr = Trainer(tm, toc, FramesData(SyntheticTokens(cfg.vocab_size,
                                                      **data_kw),
                                      cfg.encoder_seq, cfg.d_model),
                  TrainerConfig())
    ttr.start_step = 0
    state = ttr.run({"params": tp, "opt": init_opt_state(tp, toc)}, 2)
    assert len(ttr.history) == len(jtr.history) == 2
    for th, jh in zip(ttr.history, jtr.history):
        for k in ("ce_loss", "loss", "accuracy", "tokens"):
            np.testing.assert_allclose(th[k], float(jh[k]), rtol=1e-5,
                                       err_msg=k)
    assert state["params"]["dec_layers"]["cross"]["w_q"].shape == \
        jstate["params"]["dec_layers"]["cross"]["w_q"].shape
