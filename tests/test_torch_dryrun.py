"""The port's dry run (``repro_torch.launch.dryrun`` / ``cost`` /
``analysis``) against the reference's (``repro.launch.dryrun`` /
``hlo_cost`` / ``hlo_analysis``) on the CPU.

The reference runs in one subprocess with
``--xla_force_host_platform_device_count=8``, on meshes built with
``axis_types=Auto`` (jax 0.9.0's ``jax.make_mesh`` builds Explicit axes,
on which the reference's ``with_sharding_constraint`` raises): it lowers
and compiles each cell of seven families' reduced configs at 4 × 64 —
train, prefill and decode, on one device and on (2, 2) — and reports
``hlo_cost.analyze`` FLOPs and ``memory_analysis`` argument bytes.  The
port runs the same cell on a ``MeshLayout`` (rank 0) on the meta device.

* **One device**: FLOPs equal to rel 1e-6.  For ssm / hybrid the scan
  is taken out of both sides: the port's K9 / K9b counts, and the
  reference's scan FLOPs — the cell compiled again with ``ssd_chunked``
  swapped for an elementwise stand-in of the same shapes and gradient
  paths (no dot), the difference being the scan's (in a train step the
  scan inside the remat'd layer costs more than ``ssd_chunked``'s VJP
  compiled alone).  A windowed config's decode (llava) counts K5 over the
  window, where the reference's dense decode counts every position: that
  gap is computed.
* **(2, 2)**: per-rank FLOPs within 3 % of the reference's per-device
  count (the scan term out as above), except arctic's and deepseek's
  train, where GSPMD computes more than a quarter; both are printed.  A
  Mamba mixer's B and C projections run on the rank's stripe of the
  sequence, as the reference's do, so nothing is taken out for them.
* **Argument bytes** equal, except where a difference is known and
  computed: int8 moments (the port shards an int8 moment's ``q`` /
  ``scale``, the reference replicates them), whisper's decode (the
  reference's jit drops the unused encoder and cross ``w_k`` / ``w_v``
  weights, its ``cache_spec`` gives the self caches H heads, and it
  keeps the cross caches' heads whole over "model"), deepseek's (2, 2)
  decode (the port keeps MLA's latent caches whole, the reference splits
  their sequence over "model") and an SSM's decode (the reference's jit
  drops ``cur_len``, which its recurrent decode does not read).
* ``param_count`` / ``model_flops`` equal for every config and shape;
  ``io_cost`` equal for every reduced config on (2, 2); ``cache_spec``
  the reference's names and shapes for every full config (and the
  reduced ones but whisper's, whose self caches differ as above).
* One full-width cell, llama3.2-3b × train_4k × 16 × 16, runs and
  returns status ok.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import pytest

from repro.configs import get_config as ref_config
from repro.launch import hlo_analysis as ha
from repro.models.model import LanguageModel as RefModel
from repro_torch.configs import all_arch_names, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.dist.sharding import MeshLayout, ShardCtx, param_shardings
from repro_torch.launch import analysis, dryrun
from repro_torch.launch import specs as sp
from repro_torch.models.model import LanguageModel

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("llama3.2-3b", "llava-next-mistral-7b", "whisper-small",
         "arctic-480b", "deepseek-v2-236b", "mamba2-1.3b", "zamba2-1.2b")
KINDS = ("train", "prefill", "decode")
MESHES = ((1, 1), (2, 2))
B, S = 4, 64
GSPMD_MORE = {("arctic-480b", "train"), ("deepseek-v2-236b", "train")}

_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp
jax.devices()
from jax.sharding import AxisType
from repro import ckpt
from repro.configs import all_arch_names, get_config
from repro.configs.base import ShapeConfig
from repro.dist.sharding import ShardCtx, param_shardings, use_mesh
from repro.launch import dryrun, hlo_cost, specs
from repro.models import mamba
from repro.optim import OptimizerConfig

ARCHS, KINDS, MESHES, B, S = json.loads(sys.argv[1])
real_scan = mamba.ssd_chunked

def no_dot_scan(x, dt, A, Bm, Cm, chunk, initial_state=None):
    # the scan's shapes and gradient paths, elementwise: no dot
    g = (dt * A)[..., None] * (Bm.sum(-1) + Cm.sum(-1))[:, :, None, None]
    y = (x * g).astype(x.dtype)
    st = jnp.zeros((*x.shape[:1], *x.shape[2:], Bm.shape[-1]),
                   jnp.float32) + A[None, :, None, None]
    return y, st

def mesh_of(shape):
    return jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])

def compile_cell(cfg, kind, shape):
    mesh = mesh_of(shape)
    with use_mesh(mesh, pure_dp=cfg.pure_dp) as ctx:
        lowered, _ = dryrun.lower_cell(cfg, ShapeConfig("t", S, B, kind),
                                       mesh, ctx)
        return lowered.compile()

out = {"cells": {}, "io_cost": {}}
for arch in ARCHS:
    cfg = get_config(arch).reduced()
    for kind in KINDS:
        for shape in MESHES:
            comp = compile_cell(cfg, kind, shape)
            rec = {"flops": hlo_cost.analyze(comp.as_text()).flops,
                   "args": comp.memory_analysis().argument_size_in_bytes}
            if cfg.family in ("ssm", "hybrid") and kind != "decode":
                mamba.ssd_chunked = no_dot_scan
                try:
                    rec["flops_no_scan"] = hlo_cost.analyze(
                        compile_cell(cfg, kind, shape).as_text()).flops
                finally:
                    mamba.ssd_chunked = real_scan
            out["cells"][f"{arch}|{kind}|{shape[0]}x{shape[1]}"] = rec
ctx = ShardCtx(mesh_of((2, 2)))
for arch in all_arch_names():
    cfg = get_config(arch).reduced()
    oc = OptimizerConfig(state_dtype=cfg.optimizer_state_dtype)
    params = specs.params_only_specs(cfg)
    rec = {"params": ckpt.io_cost(params, param_shardings(params, ctx))}
    if cfg.optimizer_state_dtype == "float32":
        rec["state"] = ckpt.io_cost(specs.state_specs(cfg, oc),
                                    specs.state_shardings(cfg, oc, ctx))
    out["io_cost"][arch] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    args = json.dumps([ARCHS, KINDS, MESHES, B, S])
    code = ("import os\nos.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=8'\n"
            "import sys\nsys.path.insert(0, 'src')\n" + _REFERENCE)
    proc = subprocess.run([sys.executable, "-c", code, args], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


_PORT = {}


def _port(arch, kind, shape):
    """The port's rank-0 (CostReport, argument bytes) of the cell."""
    key = (arch, kind, shape)
    if key not in _PORT:
        cfg = get_config(arch).reduced()
        rep, args, _ = dryrun.trace_cell(
            cfg, ShapeConfig("t", S, B, kind),
            MeshLayout(shape, ("data", "model")), 0)
        _PORT[key] = (rep, args)
    return _PORT[key]


def _ref(reference, arch, kind, shape):
    return reference["cells"][f"{arch}|{kind}|{shape[0]}x{shape[1]}"]


def _compared_flops(reference, arch, kind, shape):
    """(the port's, the reference's) FLOPs of the cell, with the scan's
    term out of both for ssm / hybrid, and the known window gap of a
    windowed decode added to the port's."""
    cfg = get_config(arch).reduced()
    rep, _ = _port(arch, kind, shape)
    ref = _ref(reference, arch, kind, shape)
    if "flops_no_scan" in ref:
        scan = {k: v for k, v in rep.kernels.items() if k in ("k9", "k9b")}
        assert scan, "the port's step ran no K9"
        return rep.flops - sum(v[1] for v in scan.values()), ref["flops_no_scan"]
    got = rep.flops
    if kind == "decode" and cfg.sliding_window:
        # K5 counts the window; the reference's dense decode every
        # position: 4 FLOPs per (query head, position, hd) beyond it
        m = shape[0] * shape[1]
        got += (cfg.num_layers * 4 * B * cfg.num_heads
                * (S - cfg.sliding_window) * cfg.head_dim) // m
    return got, ref["flops"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_one_device_flops_equal_the_reference(reference, arch, kind):
    got, want = _compared_flops(reference, arch, kind, (1, 1))
    assert got == pytest.approx(want, rel=1e-6), (got, want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_two_by_two_flops_near_the_reference(reference, arch, kind):
    got, want = _compared_flops(reference, arch, kind, (2, 2))
    print(f"{arch} {kind} (2, 2): port {got:.6e}, reference {want:.6e}, "
          f"ratio {got / want:.4f}")
    if (arch, kind) in GSPMD_MORE:
        return                       # printed, not asserted
    assert got == pytest.approx(want, rel=0.03), (got, want)


def _bytes(tree):
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _known_arg_gap(arch, kind, shape):
    """The reference's argument bytes minus the port's, where they differ
    by design (module docs)."""
    cfg = get_config(arch).reduced()
    mesh = MeshLayout(shape, ("data", "model"))
    ctx = ShardCtx(mesh, rank=0)
    if kind == "train" and cfg.optimizer_state_dtype == "int8":
        oc = dryrun.optimizer_config(cfg)
        state = sp.state_specs(cfg, oc)
        sh = sp.state_shardings(cfg, oc, ctx)
        gap = 0
        for mom in ("m", "v"):
            full = _bytes(state["opt"][mom])
            gap += full - dryrun.shard_bytes(state["opt"][mom],
                                             sh["opt"][mom], 0)
        return gap
    if kind != "decode":
        return 0
    scfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)
    params = sp.params_only_specs(scfg)
    psh = param_shardings(params, ctx)
    m = shape[1]
    if cfg.family == "ssm":
        return -4                    # cur_len, dropped as unused
    if cfg.family == "encdec":
        unused = {"enc_layers": params["enc_layers"],
                  "enc_norm": params["enc_norm"]}
        gap = -dryrun.shard_bytes(unused, {k: psh[k] for k in unused}, 0)
        cross = params["dec_layers"]["cross"]
        for w in ("w_k", "w_v"):
            gap -= dryrun.shard_bytes(
                cross[w], psh["dec_layers"]["cross"][w], 0)
        # self caches: the reference's H heads against the port's KH;
        # cross caches: whole heads there, the rank's H/m here
        b = B // shape[0]
        per_head = 2 * cfg.num_layers * b * S * cfg.head_dim * 4
        cross = 2 * cfg.num_layers * b * cfg.encoder_seq * cfg.num_heads \
            * cfg.head_dim * 4
        return (gap + per_head * (cfg.num_heads - cfg.num_kv_heads) // m
                + cross - cross // m)
    if cfg.use_mla:
        b = B // shape[0]
        latents = cfg.num_layers * b * S * (cfg.kv_lora_rank
                                            + cfg.qk_rope_head_dim) * 4
        return -(latents - latents // m)
    return 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", MESHES, ids=["1x1", "2x2"])
def test_argument_bytes_equal_the_reference(reference, arch, kind, shape):
    _, got = _port(arch, kind, shape)
    want = _ref(reference, arch, kind, shape)["args"]
    assert got + _known_arg_gap(arch, kind, shape) == want, (got, want)


@pytest.mark.parametrize("arch", all_arch_names())
def test_param_count_and_model_flops_equal(arch):
    for reduced in (False, True):
        cfg, rcfg = get_config(arch), ref_config(arch)
        if reduced:
            cfg, rcfg = cfg.reduced(), rcfg.reduced()
        assert analysis.param_count(cfg) == ha.param_count(rcfg)
        for shape in SHAPES:
            assert analysis.model_flops(cfg, shape) == ha.model_flops(
                rcfg, shape)


@pytest.mark.parametrize("arch", all_arch_names())
def test_io_cost_equals_the_reference(reference, arch):
    from repro_torch import ckpt
    from repro_torch.optim import OptimizerConfig
    cfg = get_config(arch).reduced()
    ctx = ShardCtx(MeshLayout((2, 2), ("data", "model")))
    params = sp.params_only_specs(cfg)
    want = reference["io_cost"][arch]
    assert ckpt.io_cost(params, param_shardings(params, ctx)) == \
        want["params"]
    if "state" in want:
        oc = OptimizerConfig(state_dtype=cfg.optimizer_state_dtype)
        assert ckpt.io_cost(sp.state_specs(cfg, oc),
                            sp.state_shardings(cfg, oc, ctx)) == \
            want["state"]


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[".".join(prefix + (k,))] = v
    return out


@pytest.mark.parametrize("arch", all_arch_names())
def test_cache_spec_has_the_reference_names_and_shapes(arch):
    for reduced in (False, True):
        cfg, rcfg = get_config(arch), ref_config(arch)
        if reduced:
            if cfg.family == "encdec":
                continue         # self caches: KH heads here, H there
            cfg, rcfg = cfg.reduced(), rcfg.reduced()
        got = _flat(LanguageModel(cfg, device="meta").cache_spec(8, 64))
        want = _flat(RefModel(rcfg).cache_spec(8, 64))
        assert sorted(got) == sorted(want)
        for name, leaf in got.items():
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(want[name].shape), name
            assert str(leaf.dtype).split(".")[-1] == \
                jnp.dtype(want[name].dtype).name, name


def test_full_width_cell_runs(tmp_path):
    rec = dryrun.run_cell("llama3.2-3b", "train_4k", False, verbose=False)
    assert rec["status"] == "ok"
    assert rec["mesh"] == "16x16" and rec["compile_s"] is None
    rl = rec["roofline"]
    assert rl["flops"] > 0 and rl["hbm_bytes"] > 0
    assert rec["collectives"]["total"] > 0
    assert rec["memory"]["peak_size_in_bytes"] > \
        rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["ckpt_io"]["ranges"] > 0
    # the CLI writes the record where it is told
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                 "--out", str(out)])
    cells = json.loads(out.read_text())["cells"]
    assert cells["smollm-360m|decode_32k|16x16"]["status"] == "ok"


def test_long_500k_skipped_where_not_applicable():
    rec = dryrun.run_cell("llama3.2-3b", "long_500k", False, verbose=False)
    assert rec["status"] == "skipped"


def test_axis_rates_put_model_groups_within_a_node_on_nvlink():
    rates = analysis.axis_rates(MeshLayout((4, 8), ("data", "model")))
    assert rates == {"data": analysis.H100_NIC_BYTES,
                     "model": analysis.H100_NVLINK_BYTES}
    rates = analysis.axis_rates(MeshLayout((16, 16), ("data", "model")))
    assert rates == {"data": analysis.H100_NIC_BYTES,
                     "model": analysis.H100_NIC_BYTES}
