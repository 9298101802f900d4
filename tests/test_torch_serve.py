"""The port's serve engine: token streams identical to the JAX engine's on
the same weights (with and without forced eviction, and through the flash
branch), the copied runtime's engine tests, and the copied runtime's
copy-backend guard."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.models.model import LanguageModel as JModel
from repro.serve.engine import ModelBackend as JBackend
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import Runtime
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models.model import LanguageModel as TModel
from repro_torch.serve.engine import ModelBackend as TBackend
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import (ServeEngine, SyntheticBackend,
                                      poisson_workload)


def _serve(engine_cls, backend_cls, request_cls, model, params, prompts, *,
           pool_pages, budget, prompt_pad, page):
    bk = backend_cls(model, params, pool_pages=pool_pages, page_size=page,
                     prompt_pad=prompt_pad)
    eng = engine_cls(bk, b_cap=3, pool_pages=pool_pages, max_pages=8,
                     resident_budget=budget)
    reqs = [request_cls(rid=i, arrival=1e-4 * i, prompt=p.copy(), gen=8)
            for i, p in enumerate(prompts)]
    m = eng.run(reqs)
    return [r.out for r in reqs], m


@pytest.mark.parametrize("lens,prompt_pad,over", [
    ((10, 7, 12), 16, {}),
    ((40, 33, 36), 40, {"attn_flash_min_seq": 8}),   # prefill goes flash
])
def test_engine_matches_jax_engine_through_spill(lens, prompt_pad, over,
                                                 monkeypatch):
    page = 8
    jcfg = dataclasses.replace(jget("smollm-360m").reduced(), **over)
    tcfg = dataclasses.replace(tget("smollm-360m").reduced(), **over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    flash_calls = []
    plain = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **k: flash_calls.append(1) or plain(*a, **k))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, jcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    need = -(-max(lens) // page) + 1       # pages of the longest request
    runs = {}
    for name, budget, pool in (("ample", None, 16 + 3 * need),
                               ("tight", 2, need + 1)):
        jout, _ = _serve(JEngine, JBackend, JRequest, jm, jp, prompts,
                         pool_pages=pool, budget=budget,
                         prompt_pad=prompt_pad, page=page)
        tout, tm_ = _serve(ServeEngine, TBackend, TRequest, tm, tp, prompts,
                           pool_pages=pool, budget=budget,
                           prompt_pad=prompt_pad, page=page)
        assert tout == jout, name
        runs[name] = (tout, tm_)
    assert runs["tight"][1]["evictions"] > 0
    assert runs["tight"][1]["spilled_objects"] > 0
    assert runs["ample"][0] == runs["tight"][0]
    assert bool(flash_calls) == bool(over)


def test_slot_reuse_after_retirement_memoizes_creator():
    reqs = poisson_workload(12, rate=500.0, prompt_len=(4, 8), gen=(2, 4),
                            seed=3)
    eng = ServeEngine(SyntheticBackend(page_size=4), b_cap=3, pool_pages=16,
                      max_pages=4)
    eng.run(reqs)
    assert eng.rt.stats.creator_calls == 3
    for r in reqs:
        assert len(r.out) == r.gen and r.t_done >= 0


def test_spill_pressure_tokens_exact_and_spills():
    reqs = poisson_workload(30, rate=300.0, prompt_len=(8, 24), gen=(8, 24),
                            seed=1)
    eng = ServeEngine(SyntheticBackend(page_size=8), b_cap=8, pool_pages=20,
                      max_pages=6, resident_budget=4)
    m = eng.run(reqs)
    assert m["spilled_objects"] > 0
    assert m["evictions"] > 0 and m["resumes"] > 0
    for r in reqs:
        exp = [(r.rid * 2654435761 + c * 97) % 50257
               for c in range(len(r.prompt), len(r.prompt) + r.gen)]
        assert r.out == exp


@pytest.mark.parametrize("backend", ["pallas", "tpu", ""])
def test_runtime_rejects_unported_copy_backends(backend):
    """Only "numpy" and "cuda" (the ported fused copy) exist in the port;
    the reference's "pallas" and any other name raise."""
    with pytest.raises(NotImplementedError):
        Runtime(copy_backend=backend)
    assert Runtime(copy_backend="numpy").copy_backend == "numpy"


def test_model_backend_evict_restore_is_bit_exact_in_bf16():
    cfg = dataclasses.replace(tget("smollm-360m").reduced(),
                              dtype="bfloat16", param_dtype="bfloat16")
    import torch
    model = TModel(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    bk = TBackend(model, params, pool_pages=6, page_size=4, prompt_pad=8)
    bk.k_pools.normal_(generator=torch.Generator().manual_seed(1))
    bk.v_pools.normal_(generator=torch.Generator().manual_seed(2))
    before_k, before_v = bk.k_pools.clone(), bk.v_pools.clone()
    raw = bk.evict_row(0, [4, 1])
    assert len(raw) == 2 * bk.page_bytes
    bk.k_pools.zero_()
    bk.v_pools.zero_()
    bk.restore_row(0, [4, 1], raw, cur_len=6)
    for pool, ref in ((bk.k_pools, before_k), (bk.v_pools, before_v)):
        assert torch.equal(pool[:, [4, 1]].view(torch.int16),
                           ref[:, [4, 1]].view(torch.int16))
