"""The port's sharding layout (``repro_torch.dist.sharding``, no process
group) against the reference's ``repro.dist.sharding``.

The reference runs in a subprocess with
``--xla_force_host_platform_device_count=8``, as its own sharded tests
do, on four contexts: a (2, 4) ("data", "model") mesh, a (2, 2, 2) and a
(2, 4, 1) ("pod", "data", "model") mesh (on the last, batch 4 does not
divide pod × data = 8 and takes the prefix "pod"), and (2, 4) in
``pure_dp`` mode.  On each the port's ``resolve`` / ``spec`` must equal
the reference's for every logical axis on a range of dims; for all ten
configs, reduced and full, ``param_shardings`` must give every leaf the
reference's spec; for the ten reduced configs and two full ones
(smollm-360m, whisper-small; the other full configs take 1–80 s each in
the reference's Python range loops) ``partition_tree_of`` and
``device_ranges_of`` must give every leaf the same range lists (held as
their count and a digest of the lists); and ``moe_bucket_ranges`` the
same lists.  A hypothesis property mirrors
``test_partition_tree_of_properties_hypothesis``: the distinct ranges
are disjoint, tile the buffer, pass the port's ``db_partition`` and are
lane-aligned where the run allows.
"""
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.configs import all_arch_names, get_config
from repro_torch.dist.sharding import (MeshLayout, NamedSharding, ShardCtx,
                                       device_ranges_of, moe_bucket_ranges,
                                       param_shardings, partition_tree_of)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import params_only_specs

ROOT = pathlib.Path(__file__).resolve().parents[1]

MESHES = {"data_model": ((2, 4), ("data", "model"), False),
          "pod": ((2, 2, 2), ("pod", "data", "model"), False),
          "pod_prefix": ((2, 4, 1), ("pod", "data", "model"), False),
          "pure_dp": ((2, 4), ("data", "model"), True)}
LOGICAL = ("dp", "fsdp", "tp", "model", "ep", "sp", "kv_seq", "vocab")
DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 24)
FULL_RANGES = ("smollm-360m", "whisper-small")
BUCKETS = ((8, 3, 16, 4), (128, 10, 7168, 2), (160, 6, 5120, 2),
           (4, 1, 128, 4), (6, 5, 32, 4))


def _digest(ranges):
    arr = np.asarray(ranges, dtype=np.int64).reshape(-1)
    return [len(ranges), hashlib.sha1(arr.tobytes()).hexdigest()]


def _entry(e):
    if e is None or isinstance(e, str):
        return e
    return list(e)


# The subprocess body: the reference's view of every case, as JSON.
_REFERENCE = r"""
import hashlib, json, sys
import jax, numpy as np
from repro.configs import all_arch_names, get_config
from repro.dist.sharding import (ShardCtx, device_ranges_of,
                                 moe_bucket_ranges, param_shardings,
                                 partition_tree_of)
from repro.launch.specs import params_only_specs

MESHES, LOGICAL, DIMS, FULL_RANGES, BUCKETS = json.loads(sys.argv[1])

def digest(ranges):
    arr = np.asarray(ranges, dtype=np.int64).reshape(-1)
    return [len(ranges), hashlib.sha1(arr.tobytes()).hexdigest()]

def entry(e):
    return e if e is None or isinstance(e, str) else list(e)

def spec_list(spec, ndim):
    s = [entry(e) for e in spec]
    return s + [None] * (ndim - len(s))

out = {}
for name, (shape, axes, pure) in MESHES.items():
    ctx = ShardCtx(jax.make_mesh(tuple(shape), tuple(axes)), pure_dp=pure)
    res = {"resolve": {l: [entry(ctx.resolve(l, d)) for d in DIMS]
                       for l in LOGICAL},
           "specs": {}, "ranges": {}}
    for arch in all_arch_names():
        for full in (False, True):
            cfg = get_config(arch) if full else get_config(arch).reduced()
            shapes = params_only_specs(cfg)
            sh = param_shardings(shapes, ctx)
            key = f"{arch}:{'full' if full else 'reduced'}"
            specs, ranges = {}, {}
            flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
            for (path, leaf), s in zip(flat, jax.tree_util.tree_leaves(sh)):
                p = ".".join(k.key for k in path)
                specs[p] = spec_list(s.spec, len(leaf.shape))
                if full and (arch not in FULL_RANGES or name != "data_model"):
                    continue
                item = np.dtype(leaf.dtype).itemsize
                ranges[p] = [digest(partition_tree_of(leaf.shape, item, s)),
                             [digest(r) for _d, r in device_ranges_of(
                                 leaf.shape, item, s)]]
            res["specs"][key] = specs
            if ranges:
                res["ranges"][key] = ranges
    res["buckets"] = [moe_bucket_ranges(*b, ctx) for b in BUCKETS]
    res["launch_specs"] = launch_specs(ctx)
    out[name] = res
print(json.dumps(out))
"""

# The reference's launch/specs.py trees on one context (same subprocess).
_REFERENCE_SPECS = r"""
from repro.configs.base import SHAPES
from repro.launch import specs as S
from repro.models.model import LanguageModel
from repro.optim import OptimizerConfig

def flat_specs(shapes, shardings):
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {".".join(str(getattr(k, "key", k)) for k in path):
            [list(leaf.shape), spec_list(s.spec, len(leaf.shape))]
            for (path, leaf), s in zip(flat, jax.tree_util.tree_leaves(
                shardings))}

def launch_specs(ctx):
    out = {}
    for arch in SPEC_ARCHS:
        cfg = get_config(arch).reduced()
        for shape in SHAPES:
            out[f"{arch}:batch:{shape.name}"] = flat_specs(
                S.batch_specs(cfg, shape), S.batch_shardings(cfg, shape, ctx))
        cache = LanguageModel(cfg).cache_spec(8, 64)
        out[f"{arch}:cache"] = flat_specs(cache, S.cache_shardings(cache, ctx))
        oc = OptimizerConfig()
        out[f"{arch}:state"] = flat_specs(S.state_specs(cfg, oc),
                                          S.state_shardings(cfg, oc, ctx))
    return out
"""
SPEC_ARCHS = ("llama3.2-3b", "mamba2-1.3b", "zamba2-1.2b", "whisper-small",
              "deepseek-v2-236b")


@pytest.fixture(scope="module")
def reference():
    args = json.dumps([MESHES, LOGICAL, DIMS, FULL_RANGES, BUCKETS])
    body = textwrap.dedent(_REFERENCE)
    head, tail = body.split("\nout = {}\n")
    code = ("import os\n"
            "os.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=8'\n"
            "import sys\nsys.path.insert(0, 'src')\n" + head
            + f"\nSPEC_ARCHS = {SPEC_ARCHS!r}\n"
            + textwrap.dedent(_REFERENCE_SPECS) + "\nout = {}\n" + tail)
    proc = subprocess.run([sys.executable, "-c", code, args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _ctx(name):
    shape, axes, pure = MESHES[name]
    return ShardCtx(MeshLayout(shape, axes), pure_dp=pure)


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), tree[k]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolve_matches_reference(reference, mesh):
    ctx = _ctx(mesh)
    got = {l: [_entry(ctx.resolve(l, d)) for d in DIMS] for l in LOGICAL}
    assert got == reference[mesh]["resolve"]
    assert reference["pod_prefix"]["resolve"]["dp"][DIMS.index(4)] == "pod"


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_match_reference_for_every_config(reference, mesh):
    ctx = _ctx(mesh)
    for arch in all_arch_names():
        for full in (False, True):
            cfg = get_config(arch) if full else get_config(arch).reduced()
            sh = param_shardings(params_only_specs(cfg), ctx)
            got = {p: [_entry(e) for e in s.spec] for p, s in _flat(sh)}
            key = f"{arch}:{'full' if full else 'reduced'}"
            assert got == reference[mesh]["specs"][key], key


@pytest.mark.parametrize("mesh", list(MESHES))
def test_section6_ranges_match_reference(reference, mesh):
    ctx = _ctx(mesh)
    ref = reference[mesh]["ranges"]
    checked = 0
    for key, want in ref.items():
        arch, size = key.split(":")
        cfg = get_config(arch)
        cfg = cfg if size == "full" else cfg.reduced()
        shapes = params_only_specs(cfg)
        sh = param_shardings(shapes, ctx)
        leaves = dict(_flat(shapes))
        for p, s in _flat(sh):
            leaf = leaves[p]
            item = leaf.element_size()
            got = [_digest(partition_tree_of(tuple(leaf.shape), item, s)),
                   [_digest(r) for _d, r in device_ranges_of(
                       tuple(leaf.shape), item, s)]]
            assert got == want[p], (key, p)
            checked += 1
    assert checked > 100
    assert [list(map(list, moe_bucket_ranges(*b, ctx))) for b in BUCKETS] \
        == reference[mesh]["buckets"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_launch_specs_match_reference(reference, mesh):
    """``launch.specs``: the batch shardings of every shape cell, the
    cache shardings (``_CACHE_RULES``) of the reference's ``cache_spec``
    shapes, and the fp32 train state's shardings, leaf for leaf."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import specs
    from repro_torch.optim import OptimizerConfig
    ctx = _ctx(mesh)
    want = reference[mesh]["launch_specs"]

    def flat(sh):
        return {p: [_entry(e) for e in s.spec] for p, s in _flat(sh)}
    for arch in SPEC_ARCHS:
        cfg = get_config(arch).reduced()
        for shape in SHAPES:
            key = f"{arch}:batch:{shape.name}"
            got = flat(specs.batch_shardings(cfg, shape, ctx))
            assert got == {p: v[1] for p, v in want[key].items()}, key
        cache = {}
        for p, (shape, _spec) in want[f"{arch}:cache"].items():
            node = cache
            *path, leaf = p.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = torch.empty(shape, device="meta")
        got = flat(specs.cache_shardings(cache, ctx))
        assert got == {p: v[1] for p, v in want[f"{arch}:cache"].items()}
        got = flat(specs.state_shardings(cfg, OptimizerConfig(), ctx))
        assert got == {p: v[1] for p, v in want[f"{arch}:state"].items()}


def test_production_mesh_layouts():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    ctx = ShardCtx(multi)
    assert ctx.resolve("dp", 64) == ("pod", "data")
    assert ctx.resolve("dp", 2) == "pod"
    sh = NamedSharding(multi, (("pod", "data"), "model"))
    names = [type(p).__name__ for p in sh.placements()]
    dims = [getattr(p, "dim", None) for p in sh.placements()]
    assert names == ["Shard", "Shard", "Shard"] and dims == [0, 0, 1]


def test_partition_tree_of_properties_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st
    from repro_torch.core import NULL_GUID, Runtime, spawn_main

    meshes = (((8,), ("model",)), ((2, 4), ("data", "model")),
              ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data",
                                                        "model")))

    @st.composite
    def cases(draw):
        mi = draw(st.integers(0, len(meshes) - 1))
        mesh_shape, axes = meshes[mi]
        ndim = draw(st.integers(1, 3))
        dims = tuple(draw(st.sampled_from((1, 2, 3, 4, 6, 8, 16, 32, 48)))
                     for _ in range(ndim))
        spec = [None] * ndim
        used = set()
        for ax, size in zip(axes, mesh_shape):
            d = draw(st.integers(-1, ndim - 1))
            if d >= 0 and d not in used and dims[d] % size == 0:
                spec[d] = ax
                used.add(d)
        return mi, dims, tuple(spec), draw(st.sampled_from((1, 2, 4)))

    @settings(max_examples=40, deadline=None)
    @given(cases())
    def prop(case):
        mi, dims, spec, itemsize = case
        mesh_shape, axes = meshes[mi]
        mesh = MeshLayout(mesh_shape, axes)
        sizes = dict(zip(axes, mesh_shape))
        parts = partition_tree_of(dims, itemsize, NamedSharding(mesh, spec))
        assert len(parts) >= mesh.size
        total = int(np.prod(dims)) * itemsize
        uniq = sorted(set(parts))
        off = 0
        for o, s in uniq:
            assert o == off and s > 0, (uniq, dims, spec)
            off += s
        assert off == total, (uniq, dims, spec)
        if len(uniq) > 1:
            rt = Runtime()
            res = {}

            def main(paramv, depv, api):
                db, _ = api.db_create(total)
                api.db_release(db)
                api.db_partition(db, uniq)
                res["ok"] = True
                return NULL_GUID

            spawn_main(rt, main)
            rt.run()
            assert res.get("ok"), (dims, spec, uniq[:4])
        sharded = [i for i, a in enumerate(spec) if a is not None]
        if sharded:
            k = sharded[-1]
            run = (dims[k] // sizes[spec[k]]) * itemsize
            run *= int(np.prod(dims[k + 1:], dtype=np.int64))
            if run % 128 == 0:
                assert all(o % 128 == 0 and s % 128 == 0 for o, s in uniq)

    prop()
