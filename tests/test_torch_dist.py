"""The port's mesh paths (``repro_torch.dist``) against the JAX package's
single-device oracle, on the CPU, with 4 gloo rank processes on a (2, 2)
("data", "model") mesh.

One rank group runs every case (``_rank_cases``), started through
``launch.mesh.spawn`` inside ``subprocess.run(..., timeout=...)``, so a
hung rendezvous fails the tests instead of running into the suite's
clock; each case is then its own test.  The reference's outputs come
from its no-mesh functions on the same numpy inputs.  Tolerances are the
reference's own (``tests/test_dist.py``, ``tests/test_partition_bridge.py``):

* ``causal_attention`` as the layers call it under the mesh, each rank
  on its share: head-parallel (the rank's 3 of 6 heads and 1 of 2 kv
  heads) and context-parallel (3 heads over 1 kv head: the rank's q
  stripe at its ``q_offset`` against k / v gathered over the sequence
  by ``gather_seq``; once above the flash threshold with a pinned
  16-row tile, so the stripes take the flash path with ``q_offset``
  48): the rank's slice of the output 2e-4, of the q/k/v gradients 5e-4;
* ``decode_update_and_attend`` on caches of the rank's kv heads, and
  ``stripe_update_and_attend`` (the lse-combine) on the rank's stripe of
  a whole-head cache: output 2e-4, the rank's caches 1e-6;
  ``mla_decode_attend`` on the rank's heads: 2e-4;
* a train step of reduced llama3.2-3b, of reduced deepseek-v2-236b
  without MLA (int8 moments: the clip norm and the row scales on split
  axes; once through the psum dispatch) and, in ``pure_dp`` mode, of
  reduced smollm-360m: ce_loss 1e-3, parameters 3e-4;
* a train step of each other family (reduced qwen2-7b with its qkv
  biases, h2o-danube3-4b with its window, arctic's MoE, mamba2, zamba2,
  deepseek-v2 with MLA, whisper, llava) under the mesh: the same limits;
* prefill and 4 decodes of reduced llama3.2-3b and whisper under the
  (2, 2) mesh, and of llama under a (1, 4) mesh of the same ranks (KH 2
  < 4: ``w_q`` splits, ``w_k`` / ``w_v`` stay whole): logits 2e-4, and
  each rank's caches its slice of the reference's (the kv heads its q
  heads read; whisper's cross caches its H/m heads) at 1e-5 (computed
  through the layers, they carry fp32 summation order, up to ~2.6e-6
  from the reference and as far from the port's own one-device caches;
  the one-device model tests hold the same caches at 1e-4);
* a train step of reduced llama on the (1, 4) mesh;
* whole leaves under the mesh (``WHOLE``: 3 heads over 1 kv head, d_ff
  255, vocab 257, none of which 2 divides): a train step of reduced
  llama (context-parallel attention on the stream's stripe, the MLP on
  its rows, a whole tied unembedding on the stripe), of deepseek-v2
  with MLA (every row on every rank) and of whisper (its encoder's
  self-attention and cross attention on every row), and prefill + 4
  decodes of llama and whisper, each rank's self-attention caches its
  stripe of the sequence (the lse-combine's layout at rest);
* ``Trainer(mesh=...)`` for 2 steps from a host-leaf checkpoint the
  single-device Trainer wrote (reshard-on-restore), against the
  single-device Trainer resumed from it; a save under a mesh commits
  (``tests/test_torch_ckpt_sharded.py`` holds it against the reference);
* ``launch.train --tp 2 --backend gloo --device cpu``.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 4
MESH_MODEL = 2
GROUP_TIMEOUT_S = 400
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=50)
FAMILIES = ("mamba2-1.3b", "zamba2-1.2b", "deepseek-v2-236b",
            "whisper-small", "llava-next-mistral-7b", "qwen2-7b",
            "h2o-danube-3-4b", "arctic-480b")
# a reduced config whose heads, kv heads, d_ff and vocab 2 does not divide:
# every such leaf stays whole on the (2, 2) mesh
WHOLE = {"num_heads": 3, "num_kv_heads": 1, "d_ff": 255, "vocab_size": 257}
WHOLE_MHA = dict(WHOLE, num_kv_heads=3)    # whisper's and MLA's heads
SERVE_CASES = {  # name: (arch, config overrides, "model" axis of the mesh)
    "llama": ("llama3.2-3b", {}, 2),
    "whisper": ("whisper-small", {}, 2),
    "llama_model4": ("llama3.2-3b", {}, 4),
    "llama_whole": ("llama3.2-3b", WHOLE, 2),
    "whisper_whole": ("whisper-small", WHOLE_MHA, 2),
}
SERVE_B, SERVE_S, SERVE_STEPS = 2, 16, 4


# ------------------------------------------------------------ inputs

def _attn_inputs(h, kh, s, seed):
    rng = np.random.RandomState(seed)
    b, hd = 2, 32
    return {"q": rng.standard_normal((b, s, h, hd)).astype(np.float32),
            "k": rng.standard_normal((b, s, kh, hd)).astype(np.float32),
            "v": rng.standard_normal((b, s, kh, hd)).astype(np.float32)}


ATTN_CASES = {  # name: (heads, kv heads, seq, config overrides)
    "head_parallel": (6, 2, 64, {}),
    "context_parallel": (3, 1, 64, {}),
    "context_parallel_flash": (3, 1, 96, {"attn_flash_min_seq": 32}),
}
DECODE_CASES = {"head_parallel": (4, 2), "lse_combine": (3, 1)}


def _share_dim(name):
    """The dim of the rank's share in an attention case: heads for the
    head-parallel ones, the sequence for the others."""
    return 2 if name == "head_parallel" else 1


def _share(x, dim, coord, m=MESH_MODEL):
    """Rank ``coord``'s chunk of ``x`` along ``dim``."""
    n = x.shape[dim] // m
    if isinstance(x, np.ndarray):
        return x.take(np.arange(coord * n, (coord + 1) * n), axis=dim)
    return x.narrow(dim, coord * n, n)


def _attn_cfg(module_get, over):
    return dataclasses.replace(module_get("qwen2-7b").reduced(),
                               attn_block_q=16, attn_block_k=16, **over)


def _decode_inputs(h, kh, seed):
    rng = np.random.RandomState(seed)
    b, smax, hd = 4, 64, 32
    f = np.float32
    return {"q": rng.standard_normal((b, 1, h, hd)).astype(f),
            "kn": rng.standard_normal((b, 1, kh, hd)).astype(f),
            "vn": rng.standard_normal((b, 1, kh, hd)).astype(f),
            "kc": rng.standard_normal((b, kh, smax, hd)).astype(f),
            "vc": rng.standard_normal((b, kh, smax, hd)).astype(f),
            "cur": 37}


def _mla_inputs(cfg, seed):
    rng = np.random.RandomState(seed)
    b, smax, h = 2, 48, cfg.num_heads
    rkv, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    f = np.float32
    return {"ql": rng.standard_normal((b, 1, h, rkv)).astype(f),
            "qr": rng.standard_normal((b, 1, h, dr)).astype(f),
            "cn": rng.standard_normal((b, 1, rkv)).astype(f),
            "krn": rng.standard_normal((b, 1, dr)).astype(f),
            "ckv": rng.standard_normal((b, smax, rkv)).astype(f),
            "kr": rng.standard_normal((b, smax, dr)).astype(f),
            "cur": 29, "scale": 1.0 / np.sqrt(48.0)}


def _tokens(vocab, b, s, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}


def _family_batch(cfg, seed, b=4):
    batch = _tokens(cfg.vocab_size, b, 32, seed)
    rng = np.random.RandomState(seed + 1)
    if cfg.family == "encdec":
        batch["frames"] = (0.02 * rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = (0.02 * rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model))).astype(np.float32)
    return batch


# -------------------------------------------------------- the rank group

def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def _gathered(tree, shardings, ctx):
    from repro_torch.dist.sharding import full_tensor
    return {k: _gathered(v, shardings[k], ctx) if isinstance(v, dict)
            else full_tensor(v, shardings[k].spec, ctx).numpy()
            for k, v in tree.items()}


def _step_on_mesh(cfg, params_np, batch, oc, mesh, pure_dp=False):
    """One train step under the mesh from whole numpy parameters: the
    rank's shards in, the whole updated parameters (gathered) out."""
    from repro_torch.convert import params_from_numpy, place_state
    from repro_torch.dist.sharding import state_shardings_of, use_mesh
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import make_train_step
    model = LanguageModel(cfg, device="cpu")
    params = params_from_numpy(params_np, cfg, device="cpu")
    whole = {"params": params, "opt": init_opt_state(params, oc)}
    with use_mesh(mesh, pure_dp=pure_dp) as ctx:
        sh = state_shardings_of(whole, ctx)
    state = place_state(whole, mesh, pure_dp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with use_mesh(mesh, pure_dp=pure_dp) as ctx:
        state, metrics = make_train_step(model, oc)(state, tb)
        return ({k: float(v) for k, v in metrics.items()},
                _gathered(state["params"], sh["params"], ctx))


def _serve_on_mesh(cfg, params_np, inp, mesh):
    """Prefill, ``alloc_cache`` and the decodes under the mesh: every
    step's logits and the rank's caches at the end."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models.model import LanguageModel
    model = LanguageModel(cfg, device="cpu")
    params = params_from_numpy(params_np, cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    with use_mesh(mesh):
        logits, cache = model.prefill(params, batch)
        cache = model.alloc_cache(SERVE_B, SERVE_S + SERVE_STEPS, init=cache)
        out = [logits.numpy()]
        for i, tok in enumerate(inp["decode"]):
            logits, cache = model.decode_step(params, cache,
                                              torch.from_numpy(tok),
                                              SERVE_S + i)
            out.append(logits.numpy())
    return out, _tree_np(cache)


def _rank_cases(rank, world, path):
    """Every case of this file on one rank; returns {case: result}."""
    from repro_torch.configs import get_config
    from repro_torch.dist import flash
    from repro_torch.dist.sharding import gather_seq, use_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.data import SyntheticTokens

    inp = torch.load(os.path.join(path, "inputs.pt"), weights_only=False)
    mesh = make_host_mesh(model=MESH_MODEL)
    coord = mesh.get_local_rank("model")
    out = {"coord": coord}
    for name, (h, kh, s, over) in ATTN_CASES.items():
        cfg = _attn_cfg(get_config, over)
        dim = _share_dim(name)
        q, k, v = (_share(torch.from_numpy(inp["attn"][name][n]), dim,
                          coord).contiguous().requires_grad_()
                   for n in ("q", "k", "v"))
        with use_mesh(mesh):
            if dim == 2:             # the rank's heads
                o = flash.causal_attention(q, k, v, cfg=cfg)
            else:                    # the rank's stripe, as blocks runs it
                o = flash.causal_attention(
                    q, gather_seq(k), gather_seq(v), cfg=cfg,
                    q_offset=coord * q.shape[1])
            grads = torch.autograd.grad(torch.sin(o).sum(), (q, k, v))
        out["attn_" + name] = [o.detach().numpy()] + [g.numpy()
                                                      for g in grads]
    for name in DECODE_CASES:
        d = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in inp["decode"][name].items()}
        with use_mesh(mesh):
            if name == "head_parallel":       # the rank's heads
                o, kc, vc = flash.decode_update_and_attend(
                    *(_share(d[n], 2, coord).contiguous()
                      for n in ("q", "kn", "vn")),
                    *(_share(d[n], 1, coord).contiguous()
                      for n in ("kc", "vc")), d["cur"])
            else:                             # the rank's sequence stripe
                o, kc, vc = flash.stripe_update_and_attend(
                    d["q"], d["kn"], d["vn"],
                    *(_share(d[n], 2, coord).contiguous()
                      for n in ("kc", "vc")), d["cur"])
        out["decode_" + name] = [o.numpy(), kc.numpy(), vc.numpy()]
    d = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in inp["mla"].items()}
    with use_mesh(mesh):
        o, ckv, kr = flash.mla_decode_attend(
            _share(d["ql"], 2, coord), _share(d["qr"], 2, coord), d["cn"],
            d["krn"], d["ckv"], d["kr"], d["cur"], scale=d["scale"])
    out["mla_decode"] = [o.numpy(), ckv.numpy(), kr.numpy()]

    for name, (arch, over, pure_dp) in STEP_CASES.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        oc = OptimizerConfig(state_dtype=cfg.optimizer_state_dtype, **OPT)
        out["step_" + name] = _step_on_mesh(
            cfg, inp["steps"][name]["params"], inp["steps"][name]["batch"],
            oc, mesh, pure_dp)

    for arch in FAMILIES:
        cfg = get_config(arch).reduced()
        oc = OptimizerConfig(state_dtype=cfg.optimizer_state_dtype, **OPT)
        params_np, batch = inp["families"][arch]
        try:
            out["family_" + arch] = _step_on_mesh(cfg, params_np, batch, oc,
                                                  mesh)
        except NotImplementedError as e:
            out["family_" + arch] = ("refused", str(e))

    meshes = {2: mesh, 4: make_host_mesh(model=4)}
    for name, (arch, over, m) in SERVE_CASES.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        out["serve_" + name] = (_serve_on_mesh(
            cfg, inp["serve"][name]["params"], inp["serve"][name],
            meshes[m]), meshes[m].get_local_rank("model"))
    cfg = get_config("llama3.2-3b").reduced()
    out["step_llama_model4"] = _step_on_mesh(
        cfg, inp["steps"]["llama"]["params"], inp["steps"]["llama"]["batch"],
        OptimizerConfig(**OPT), meshes[4])

    # Trainer: reshard-on-restore of the single-device Trainer's checkpoint
    cfg = get_config("llama3.2-3b").reduced()
    model = LanguageModel(cfg, device="cpu")
    oc = OptimizerConfig(**OPT)
    data = SyntheticTokens(cfg.vocab_size, batch=4, seq=32, seed=3)
    tr = Trainer(model, oc, data, TrainerConfig(ckpt_dir=inp["ckpt_dir"]),
                 mesh=mesh)
    state = tr.init_or_restore(torch.Generator().manual_seed(1))
    start = tr.start_step
    state = tr.run(state, 2)
    from repro_torch.dist.sharding import ShardCtx, param_shardings
    from repro_torch.models.model import param_shapes
    with use_mesh(mesh) as ctx:
        params = _gathered(state["params"],
                           param_shardings(param_shapes(cfg), ctx), ctx)
    # a save under the mesh (its own directory: the reference reads the
    # host checkpoint's meanwhile)
    from repro_torch import ckpt
    saved_dir = os.path.join(path, "mesh_ckpt")
    saver = Trainer(model, oc, data, TrainerConfig(
        ckpt_dir=saved_dir, ckpt_every=1, async_ckpt=False), mesh=mesh)
    saver.run(saver.init_or_restore(torch.Generator().manual_seed(2)), 1)
    with open(os.path.join(saved_dir, "step_1", "manifest.json")) as f:
        saved = (ckpt.latest_step(saved_dir), '"ranges"' in f.read())
    out["trainer"] = (start, [h["ce_loss"] for h in tr.history], params,
                      saved, ShardCtx(mesh).axis_sizes)
    return out


STEP_CASES = {  # name: (arch, config overrides, pure_dp)
    "llama": ("llama3.2-3b", {}, False),
    "moe_int8": ("deepseek-v2-236b", {"use_mla": False}, False),
    # the psum region on the sequence-split stream (gather_seq in,
    # scatter_seq out)
    "moe_psum": ("deepseek-v2-236b", {"use_mla": False,
                                      "moe_dispatch": "psum"}, False),
    "pure_dp": ("smollm-360m", {}, True),
    # whole leaves: context-parallel GQA, every row for MLA and whisper's
    # encoder and cross attention, MLPs on the rows, a whole unembedding
    "llama_whole": ("llama3.2-3b", WHOLE, False),
    "mla_whole": ("deepseek-v2-236b", WHOLE_MHA, False),
    "whisper_whole": ("whisper-small", WHOLE_MHA, False),
}


def _group_main(path):
    """Entry of the group's subprocess: 4 gloo ranks on the CPU."""
    from repro_torch.launch.mesh import spawn
    results = spawn(_rank_cases, RANKS, backend="gloo",
                    devices=["cpu"] * RANKS, args=(path,), timeout_s=120)
    torch.save(results, os.path.join(path, "results.pt"))


# ------------------------------------------------------------- the oracle

def _params_np(arch, over):
    """Seeded weights of a reduced config as a numpy tree (the port's
    init: both packages take the same tree)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LanguageModel
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    return _tree_np(LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)))


def _inputs(tmp):
    """Every case's numpy inputs and the single-device Trainer's host
    checkpoint after 2 steps (no JAX: the rank group starts on these
    while the reference computes)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    inp = {"attn": {}, "decode": {}, "steps": {}, "families": {}}
    for i, (name, (h, kh, s, _over)) in enumerate(ATTN_CASES.items()):
        inp["attn"][name] = _attn_inputs(h, kh, s, seed=10 + i)
    for i, (name, (h, kh)) in enumerate(DECODE_CASES.items()):
        inp["decode"][name] = _decode_inputs(h, kh, seed=20 + i)
    inp["mla"] = _mla_inputs(get_config("deepseek-v2-236b").reduced(), 30)
    for i, (name, (arch, over, pure)) in enumerate(STEP_CASES.items()):
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        inp["steps"][name] = {"params": _params_np(arch, over),
                              "batch": _family_batch(cfg, 40 + i,
                                                     8 if pure else 4)}
    for i, arch in enumerate(FAMILIES):
        inp["families"][arch] = (_params_np(arch, {}), _family_batch(
            get_config(arch).reduced(), 50 + i))
    inp["serve"] = {}
    for i, (name, (arch, over, _m)) in enumerate(SERVE_CASES.items()):
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        rng = np.random.RandomState(60 + i)
        batch = {"tokens": rng.randint(0, cfg.vocab_size, (
            SERVE_B, SERVE_S)).astype(np.int32)}
        if cfg.family == "encdec":
            batch["frames"] = (0.02 * rng.standard_normal(
                (SERVE_B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
        inp["serve"][name] = {
            "params": _params_np(arch, over), "batch": batch,
            "decode": [rng.randint(0, cfg.vocab_size, (SERVE_B, 1)).astype(
                np.int32) for _ in range(SERVE_STEPS)]}
    cfg = get_config("llama3.2-3b").reduced()
    data = SyntheticTokens(cfg.vocab_size, batch=4, seq=32, seed=3)
    inp["ckpt_dir"] = str(tmp / "ckpt")
    tr = Trainer(LanguageModel(cfg, device="cpu"), OptimizerConfig(**OPT),
                 data, TrainerConfig(ckpt_dir=inp["ckpt_dir"], ckpt_every=2,
                                     async_ckpt=False))
    tr.run(tr.init_or_restore(torch.Generator().manual_seed(0)), 2)
    return inp


def _reference(inp):
    """The reference's no-mesh outputs on the same inputs, and the
    single-device Trainer resumed from the checkpoint for 2 steps."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.dist import flash as jflash
    from repro.models.model import LanguageModel as JModel
    from repro.optim import OptimizerConfig as JOpt
    from repro.optim import init_opt_state as jinit
    from repro.train.steps import make_train_step as jstep

    ref = {}
    # the reference's no-mesh attention through its dense path: the same
    # function as its flash kernel, without interpret mode's cost
    cfg = _attn_cfg(jget, {})

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jflash.causal_attention(q, k, v, cfg=cfg)))
    for name in ATTN_CASES:
        args = [jnp.asarray(inp["attn"][name][n]) for n in ("q", "k", "v")]
        o = jflash.causal_attention(*args, cfg=cfg)
        grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
        ref["attn_" + name] = [np.asarray(o)] + [np.asarray(g) for g in grads]
    for name in DECODE_CASES:
        x = inp["decode"][name]
        o, kc, vc = jflash.decode_update_and_attend(
            *(jnp.asarray(x[n]) for n in ("q", "kn", "vn", "kc", "vc")),
            jnp.asarray(x["cur"], jnp.int32))
        ref["decode_" + name] = [np.asarray(t) for t in (o, kc, vc)]
    x = inp["mla"]
    o, ckv, kr = jflash.mla_decode_attend(
        *(jnp.asarray(x[n]) for n in ("ql", "qr", "cn", "krn", "ckv", "kr")),
        jnp.asarray(x["cur"], jnp.int32), scale=x["scale"])
    ref["mla_decode"] = [np.asarray(t) for t in (o, ckv, kr)]

    def step(cfg, params_np, batch_np):
        jm = JModel(cfg)
        jp = jax.tree_util.tree_map(jnp.asarray, params_np)
        joc = JOpt(state_dtype=cfg.optimizer_state_dtype, **OPT)
        batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        state, met = jax.jit(jstep(jm, joc))(
            {"params": jp, "opt": jinit(jp, joc)}, batch)
        return ({k: float(v) for k, v in met.items()},
                jax.tree_util.tree_map(np.asarray, state["params"]))

    for name, (arch, over, _pure) in STEP_CASES.items():
        ref["step_" + name] = step(
            dataclasses.replace(jget(arch).reduced(), **over),
            inp["steps"][name]["params"], inp["steps"][name]["batch"])
    for arch in FAMILIES:
        ref["family_" + arch] = step(jget(arch).reduced(),
                                     *inp["families"][arch])
    for name, (arch, over, _m) in SERVE_CASES.items():
        ref["serve_" + name] = _reference_serve(
            dataclasses.replace(jget(arch).reduced(), **over),
            inp["serve"][name])

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("llama3.2-3b").reduced()
    data = SyntheticTokens(cfg.vocab_size, batch=4, seq=32, seed=3)
    tr = Trainer(LanguageModel(cfg, device="cpu"), OptimizerConfig(**OPT),
                 data, TrainerConfig(ckpt_dir=inp["ckpt_dir"]))
    state = tr.run(tr.init_or_restore(torch.Generator().manual_seed(1)), 2)
    ref["trainer"] = ([h["ce_loss"] for h in tr.history],
                      _tree_np(state["params"]))
    return ref


def _reference_serve(cfg, inp):
    """The reference's no-mesh prefill and decodes: every step's logits
    and the caches at the end (the self-attention caches padded by the
    decodes' positions, as ``alloc_cache`` lays them out)."""
    import jax
    import jax.numpy as jnp
    from repro.models.model import LanguageModel as JModel
    jm = JModel(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    logits, cache = jax.jit(jm.prefill)(
        jp, {k: jnp.asarray(v) for k, v in inp["batch"].items()})
    pad = [(0, 0)] * 3 + [(0, SERVE_STEPS), (0, 0)]
    cache = {"layers": {k: jnp.pad(v, pad) if k in ("k", "v") else v
                        for k, v in cache["layers"].items()}}
    step = jax.jit(jm.decode_step)
    out = [np.asarray(logits)]
    for i, tok in enumerate(inp["decode"]):
        logits, cache = step(jp, cache, jnp.asarray(tok),
                             jnp.asarray(SERVE_S + i, jnp.int32))
        out.append(np.asarray(logits))
    return out, jax.tree_util.tree_map(np.asarray, cache)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    torch.save(_inputs(tmp), tmp / "inputs.pt")
    code = ("import sys; sys.path[:0] = ['src', 'tests']; "
            "import test_torch_dist as T; T._group_main(sys.argv[1])")
    # the rank group runs while the reference computes
    proc = subprocess.Popen([sys.executable, "-c", code, str(tmp)],
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH="src"))
    try:
        ref = _reference(torch.load(tmp / "inputs.pt", weights_only=False))
        out, err = proc.communicate(timeout=GROUP_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (out[-2000:], err[-4000:])
    return torch.load(tmp / "results.pt", weights_only=False), ref


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(tree[k])


def _params_close(got, want, tol=3e-4):
    got, want = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_p, b) in zip(got, want):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol,
                                   err_msg="/".join(path))


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_causal_attention_on_mesh_matches_reference(runs, case):
    """Each rank's output and q/k/v gradients are its share of the
    reference's (its heads, or its stripe of the sequence)."""
    results, ref = runs
    dim = _share_dim(case)
    for r in results:
        want = [_share(t, dim, r["coord"]) for t in ref["attn_" + case]]
        got = r["attn_" + case]
        np.testing.assert_allclose(got[0], want[0], atol=2e-4, rtol=2e-4)
        for a, b, n in zip(got[1:], want[1:], "qkv"):
            np.testing.assert_allclose(a, b, atol=5e-4, rtol=5e-4,
                                       err_msg="d" + n)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_on_mesh_matches_reference(runs, case):
    """Head-parallel: the rank's heads of the output and caches;
    lse-combine: the whole output, and the rank's stripe of the caches."""
    results, ref = runs
    o, kc, vc = ref["decode_" + case]
    for r in results:
        c = r["coord"]
        if case == "head_parallel":
            want = [_share(o, 2, c), _share(kc, 1, c), _share(vc, 1, c)]
        else:
            want = [o, _share(kc, 2, c), _share(vc, 2, c)]
        got = r["decode_" + case]
        np.testing.assert_allclose(got[0], want[0], atol=2e-4, rtol=2e-4)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_mla_decode_head_sharded_matches_reference(runs):
    """The rank's heads of the output; the latent caches whole."""
    results, ref = runs
    o, ckv, kr = ref["mla_decode"]
    for r in results:
        want = [_share(o, 2, r["coord"]), ckv, kr]
        got = r["mla_decode"]
        np.testing.assert_allclose(got[0], want[0], atol=2e-4, rtol=2e-4)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_on_mesh_matches_reference(runs, case):
    results, ref = runs
    want_m, want_p = ref["step_" + case]
    for r in results:
        got_m, got_p = r["step_" + case]
        assert abs(got_m["ce_loss"] - want_m["ce_loss"]) < 1e-3
        _params_close(got_p, want_p)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_on_mesh(runs, arch):
    results, ref = runs
    want_m, want_p = ref["family_" + arch]
    for r in results:
        got = r["family_" + arch]
        assert got[0] != "refused", got
        got_m, got_p = got
        assert abs(got_m["ce_loss"] - want_m["ce_loss"]) < 1e-3
        _params_close(got_p, want_p)


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_on_mesh_matches_reference(runs, case):
    """Every step's logits, and each rank's caches as its share of the
    reference's: the kv heads its q heads read (tensor-parallel: one of
    two kv heads on each rank), whisper's cross caches its H/m heads;
    where the heads stayed whole (``WHOLE``), every kv head over the
    rank's stripe of the sequence and the cross caches whole."""
    from repro_torch.configs import get_config
    results, ref = runs
    arch, over, m = SERVE_CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    want_logits, want_cache = ref["serve_" + case]
    h, kh = cfg.num_heads, cfg.num_kv_heads
    split = h % m == 0
    for r in results:
        (logits, cache), coord = r["serve_" + case]
        assert len(logits) == len(want_logits) == SERVE_STEPS + 1
        for a, b in zip(logits, want_logits):
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4)
        # the kv heads this rank's q heads read (H/m q heads a rank)
        kv = sorted({(coord * (h // m) + i) // (h // kh)
                     for i in range(h // m)})
        for name, leaf in want_cache["layers"].items():
            if name in ("k", "v") and split:
                want = leaf[:, :, kv]
            elif name in ("k", "v"):   # (L, B, KH, S, hd): the rank's stripe
                want = _share(leaf, 3, coord, m)
            elif split:    # cross caches (L, B, Se, H, hd): the rank's heads
                want = leaf[:, :, :, coord * (h // m):(coord + 1) * (h // m)]
            else:
                want = leaf
            got = cache["layers"][name]
            assert got.shape == want.shape, (name, got.shape, want.shape)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=name)


def test_train_step_on_model4_mesh_matches_reference(runs):
    """Reduced llama on (1, 4): q heads split, k / v whole (KH 2 < 4)."""
    results, ref = runs
    want_m, want_p = ref["step_llama"]
    for r in results:
        got_m, got_p = r["step_llama_model4"]
        assert abs(got_m["ce_loss"] - want_m["ce_loss"]) < 1e-3
        _params_close(got_p, want_p)


def test_trainer_on_mesh_reshards_a_host_checkpoint(runs):
    results, ref = runs
    want_loss, want_p = ref["trainer"]
    for r in results:
        start, losses, params, saved, sizes = r["trainer"]
        assert sizes == {"data": 2, "model": 2}
        assert start == 2
        np.testing.assert_allclose(losses, want_loss, rtol=1e-4)
        _params_close(params, want_p)
        assert saved == (1, True)        # committed, with §6 range tables


def test_launch_train_tp2_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--tp", "2", "--backend", "gloo", "--steps",
         "2", "--batch", "4", "--seq", "32"], cwd=ROOT, capture_output=True,
        text=True, timeout=240, env=dict(os.environ, PYTHONPATH="src"))
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    out = proc.stdout
    assert "mesh=data1xmodel2" in out, out
    assert out.count("  step ") >= 2, out
    assert "rank 0/2: backend=gloo device=cpu" in out, out
