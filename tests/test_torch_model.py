"""The whole model: weights made by the JAX ``LanguageModel.init`` and
converted with ``params_from_numpy`` give the reference's prefill logits,
cache and decode-step logits (fp32, CPU)."""
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

ATOL = 1e-4      # fp32 through a few layers; summation order only
STEPS = 3


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


@pytest.mark.parametrize("arch,seq,over", [
    ("smollm-360m", 12, {}),
    ("llama3.2-3b", 12, {}),
    ("qwen2-7b", 12, {}),                       # qkv bias
    ("h2o-danube-3-4b", 24, {}),                # sliding window 16
    ("smollm-360m", 40, {"attn_flash_min_seq": 8}),   # flash branch
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
    for name in ("k", "v"):
        _close(tcache["layers"][name], jcache["layers"][name])

    jcache = jax.tree_util.tree_map(
        lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, STEPS), (0, 0)]),
        jcache)
    tcache = tm.alloc_cache(2, seq + STEPS, init=tcache)
    jstep = jax.jit(jm.decode_step)
    for i in range(STEPS):
        tok = rng.randint(0, jm.cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = jstep(jp, jcache, jnp.asarray(tok),
                             jnp.asarray(seq + i, jnp.int32))
        tlog, tcache = tm.decode_step(tp, tcache,
                                      torch.from_numpy(tok).long(), seq + i)
        _close(tlog, jlog)
    _close(tcache["layers"]["k"], jcache["layers"]["k"])
    if over:      # seq is past the lowered threshold on both sides
        from repro.models.attention import flash_min_seq
        assert seq > flash_min_seq(jm.cfg)
        assert len(flash_calls) == jm.cfg.num_layers
    else:
        assert not flash_calls


def test_params_from_numpy_keeps_names_and_shapes():
    jm, jp, _, tp = _pair("qwen2-7b")
    flat_j = {jax.tree_util.keystr(p): np.shape(v)
              for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            else:
                flat_t["".join(f"['{p}']" for p in path + [k])] = tuple(v.shape)
    walk(tp, [])
    assert flat_t == flat_j


def test_bf16_weights_convert_bit_exactly():
    cfg = tget("smollm-360m").reduced()
    w = np.asarray(jnp.asarray(np.linspace(-3, 3, 24, dtype=np.float32)
                               .reshape(2, 3, 4), jnp.bfloat16))
    tree = {"layers": {"attn": {"w_q": np.zeros((cfg.num_layers, cfg.d_model,
                                                 cfg.num_heads, cfg.head_dim),
                                                np.float32)}},
            "embedding": w}
    got = params_from_numpy(tree, cfg, device="cpu")["embedding"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), w.astype(np.float32))


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TModel(tget("smollm-360m").reduced())           # default "cuda"
