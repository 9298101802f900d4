"""The port's AdamW against ``repro.optim``: the same gradients through
both ``adamw_update``s for a few steps, with fp32 and int8 moments, per
leaf and chunked per layer, with and without global-norm clipping; and
the learning-rate schedule.

Tolerances: fp32 elementwise arithmetic in the same order on both sides,
so parameters and fp32 moments agree to 1e-6 relative (last-ulp
differences of pow/cos/sqrt, and XLA fusing multiply-adds; a moment that
cancels to near zero is held to 1e-6 of its leaf's largest entry).
int8 moments are rounded to 1/127 (m) or 1/255 of a quartic root (v) of
the row maximum, so a last-ulp difference can move a quantized entry by
one step: the dequantized moments are held to one quantization step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw as tadamw

SHAPES = {"embedding": (64, 32),
          "final_norm": {"scale": (32,)},
          "layers": {"attn": {"w_q": (4, 32, 2, 16), "b_q": (4, 2, 16)},
                     "ln1": {"scale": (4, 32)},
                     "mlp": {"w_up": (4, 32, 48)}}}


def _tree(shapes, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(k, v)
            for k, v in shapes.items()}


def _rand(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return _tree(SHAPES, lambda _k, s: (scale * rng.randn(*s)).astype(
        np.float32))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    """Copies: the port updates in place, and JAX on the CPU may share
    the numpy buffers its arrays were made from."""
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(v.copy()) for k, v in tree.items()}


def _paths(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict) and "q" not in tree[k]:
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])   # unclipped, clipped
def test_adamw_update_matches_reference(monkeypatch, state_dtype, chunked,
                                        grad_scale):
    if chunked:   # every stacked leaf above 1 KiB updates layer by layer
        monkeypatch.setattr(jadamw, "CHUNK_BYTES", 1024)
        monkeypatch.setattr(tadamw, "CHUNK_BYTES", 1024)
    oc_kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
                 state_dtype=state_dtype)
    joc, toc = jadamw.OptimizerConfig(**oc_kw), tadamw.OptimizerConfig(**oc_kw)
    params = _rand(0)
    jp, tp = _to_jax(params), _to_torch(params)
    jst, tst = jadamw.init_opt_state(jp, joc), tadamw.init_opt_state(tp, toc)
    for step in range(3):
        grads = _rand(1 + step, grad_scale)
        jp, jst, jm = jadamw.adamw_update(joc, _to_jax(grads), jp, jst)
        tp2, tst2, tm = tadamw.adamw_update(toc, _to_torch(grads), tp, tst)
        assert tp2 is tp and tst2 is tst               # updated in place
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        if grad_scale > 1:
            assert float(jm["grad_norm"]) > joc.clip_norm   # clip engaged
    for path, want in _paths(jax.tree_util.tree_map(np.asarray, jp)):
        np.testing.assert_allclose(_at(tp, path).numpy(), want, rtol=1e-6,
                                   atol=1e-7, err_msg="/".join(path))
    for name, deq, step_frac in (("m", "_dequant_m", 1 / 127),
                                 ("v", "_dequant_v", 4 / 255)):
        for path, want in _paths(jst[name]):
            got = _at(tst[name], path)
            if state_dtype == "float32":
                w = np.asarray(want)   # cancellation: abs tol by scale
                np.testing.assert_allclose(got.numpy(), w, rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max())
                continue
            w = np.asarray(getattr(jadamw, deq)(want))
            g = getattr(tadamw, deq)(got).numpy()
            row_max = np.asarray(want["scale"]) * (127 if name == "m" else 1)
            assert got["q"].dtype == (torch.int8 if name == "m"
                                      else torch.uint8)
            assert np.all(np.abs(g - w) <= step_frac * row_max + 1e-12), path


def test_lr_schedule_matches_reference():
    oc = dict(peak_lr=3e-3, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    steps = np.array([0, 1, 4, 5, 6, 20, 39, 40, 60], np.int32)
    want = np.asarray(jadamw.lr_at(jadamw.OptimizerConfig(**oc),
                                   jnp.asarray(steps)))
    got = tadamw.lr_at(tadamw.OptimizerConfig(**oc),
                       torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] == pytest.approx(3e-3 * 0.1, rel=1e-6)   # floor after end


def test_no_decay_by_leaf_name():
    """Zero gradients isolate the decay term: only leaves outside
    _NO_DECAY shrink, by lr·wd·p."""
    oc = tadamw.OptimizerConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10,
                                weight_decay=0.5)
    params = _to_torch(_rand(0))
    before = {p: v.clone() for p, v in _paths(params)}
    state = tadamw.init_opt_state(params, oc)
    tadamw.adamw_update(oc, _to_torch(_rand(1, 0.0)), params, state)
    for path, p in _paths(params):
        if path[-1] in tadamw._NO_DECAY:
            assert torch.equal(p, before[path]), path
        else:
            torch.testing.assert_close(p, before[path] * (1 - 1e-2 * 0.5))
