"""The port's four example scripts (``examples/torch_*.py``) against the
reference's (``examples/*.py``) on the CPU.

Each script is loaded by path (``importlib``) and called in-process with
``device="cpu"``:

* ``torch_quickstart``: the same stdout as ``examples/quickstart.py``
  run as a script, character for character (the runtime's virtual clock
  makes both deterministic).
* ``torch_wavefront_pipeline`` at the reference's size, with the
  reference module's stage parameters and input activations carried
  across (``convert.params_from_numpy``): the same stdout (cell count,
  makespan, wavefront order, the exactness line), and each microbatch's
  output within 1e-5 of the largest entry of the reference's.
* ``torch_serve_lm`` at GEN 4 in fp32 (the reduced configs' dtype), its
  weights converted from the reference's ``LanguageModel.init`` and its
  prompts the reference's: the same greedy tokens as the reference's
  ``prefill`` / ``decode_step`` run as ``examples/serve_lm.py`` runs
  them, for llama3.2-3b, mamba2-1.3b and zamba2-1.2b.
* ``torch_train_lm`` at a tiny size (12 steps, a fail-stop at step 8,
  checkpoints every 4): the first run's last step is 7, the restart
  starts from ``ckpt.latest_step`` (8), and the two histories together
  are steps 0..11 in order.
"""
import contextlib
import dataclasses
import importlib.util
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _load(name, as_main=False):
    """The module of ``examples/<name>.py``; ``as_main`` runs it as the
    script (its ``__main__`` block too) and returns its stdout."""
    spec = importlib.util.spec_from_file_location(
        "__main__" if as_main else f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    if not as_main:
        spec.loader.exec_module(mod)
        return mod
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        spec.loader.exec_module(mod)
    return out.getvalue()


def _stdout(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return out.getvalue(), result


def test_quickstart_prints_the_reference_lines():
    want = _load("quickstart", as_main=True)
    got, lines = _stdout(_load("torch_quickstart").main, "cpu")
    assert got == want
    assert lines == want.splitlines()


def test_wavefront_matches_the_reference():
    from repro_torch.convert import params_from_numpy
    ref = _load("wavefront_pipeline")
    port = _load("torch_wavefront_pipeline")
    inputs = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(ref.key, 100 + m),
        (ref.B, ref.S, ref.cfg.d_model)) * 0.02) for m in range(ref.MICRO)])
    stacked = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                           *ref.stage_params)
    params = params_from_numpy(
        {"layers": stacked},
        dataclasses.replace(port.cfg, num_layers=port.STAGES), "cpu")
    want, _ = _stdout(ref.main)
    got, res = _stdout(port.main, "cpu", params, inputs)
    assert got == want
    assert res["cells"] == ref.MICRO * ref.STAGES
    for m in range(ref.MICRO):
        x = inputs[m]
        for s in range(ref.STAGES):
            x = ref.stage_fwd(ref.stage_params[s], x)
        x = np.asarray(x)
        err = np.abs(res["outputs"][m].numpy() - x).max()
        assert err <= 1e-5 * np.abs(x).max(), (m, err)


def _reference_tokens(ref_model, params, tokens, gen):
    """``examples/serve_lm.py``'s prefill, cache padding, warm-up decode
    and greedy loop, returning the prefill's argmax and each decoded
    token (B, gen)."""
    logits, cache = jax.jit(ref_model.prefill)(params, {"tokens": tokens})

    def grow(path, leaf):
        name = path[-1].key if hasattr(path[-1], "key") else ""
        if name in ("k", "v", "c_kv", "k_rope"):
            pad = [(0, 0)] * leaf.ndim
            pad[-2] = (0, gen)
            return jnp.pad(leaf, pad)
        return leaf
    cache = jax.tree_util.tree_map_with_path(grow, cache)
    decode = jax.jit(ref_model.decode_step)
    prompt = tokens.shape[1]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [tok]
    _, cache = decode(params, cache, tok, jnp.asarray(prompt, jnp.int32))
    for i in range(1, gen):
        logits, cache = decode(params, cache, tok,
                               jnp.asarray(prompt + i, jnp.int32))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.concatenate([np.asarray(t) for t in out], 1)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-1.3b",
                                  "zamba2-1.2b"])
def test_serve_gives_the_reference_tokens(arch):
    from repro.configs import get_config
    from repro.models.model import LanguageModel
    from repro_torch.convert import params_from_numpy
    ref = _load("serve_lm")
    port = _load("torch_serve_lm")
    gen = 4
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)
    assert cfg.dtype == "float32"
    model = LanguageModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (ref.B, ref.PROMPT),
                                0, cfg.vocab_size)
    want = _reference_tokens(model, params, tokens, gen)
    tree = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    _, res = _stdout(port.main, "cpu", (arch,), gen, {arch: tree},
                     {arch: np.asarray(tokens)})
    assert res[0]["arch"] == arch and res[0]["tok_s"] > 0
    np.testing.assert_array_equal(res[0]["tokens"], want)


def test_train_dies_restarts_and_continues():
    port = _load("torch_train_lm")
    _, res = _stdout(port.main, "cpu", steps=12, fail_at=8, ckpt_every=4)
    assert res["died_at"] == 7
    assert res["latest_step"] == 8
    assert res["restart_step"] == res["latest_step"]
    assert [h["step"] for h in res["history"]] == list(range(12))
    assert res["final"]["step"] == 11
    assert len(res["preds"]) == 5 and res["want"] == [295, 448, 71, 160,
                                                      359]
    assert res["lines"][0].startswith("run 1 died at step 7 ")
    assert res["lines"][1] == "restarted from step 8"
