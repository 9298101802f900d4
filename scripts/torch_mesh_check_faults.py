"""Plant faults in the mesh backward and show that ``chip_smoke.py``'s
fp32 mesh train-step check fails on each one.

    python scripts/torch_mesh_check_faults.py [--old-check] [--keep DIR]

For each fault below, the script copies ``src/`` and ``chip_smoke.py``
into a temporary directory, plants the fault in the copy's
``repro_torch/dist/sharding.py`` and runs
``chip_smoke._mesh_fp32_step`` on two gloo ranks of the CPU (reduced
configs, a 2 x 64 batch) for three meshes: smollm-360m cut to 3 heads
over 1 kv head on (1, 2) (context-parallel attention on the sequence-
split stream, its MLP and vocab tensor-parallel), llama3.2-3b on (1, 2)
(tensor-parallel: the rank's heads, hidden units and vocab rows) and
llama3.2-3b on (2, 1) (data-parallel).  The repository itself is never
changed.

Faults:

* ``none``: the code as it is (every case must pass);
* ``whole_half``: the context-parallel k/v gradient sum (``_Whole``'s
  backward) halved;
* ``gather_half``: every gathered parameter's gradient halved
  (``_GatherParam``'s backward; since tensor parallelism keeps each
  leaf's "model" share, only the (2, 1) mesh gathers, so only it sees
  this fault and ``no_dp_sum``);
* ``no_dp_sum``: the FSDP gradients' sum over "dp" dropped (their
  reduce-scatter taken as a plain cut);
* ``gather_seq_half``: the reduce-scatter of ``gather_seq``'s backward
  (the column-parallel entry from the sequence-split stream) halved;
* ``scatter_seq_half``: the all-gather of ``scatter_seq``'s backward
  (the row-parallel exit into the stream) halved.

``--old-check`` runs the check as it stood before it took the
reference test's optimizer and the gradient norm (peak lr 1e-4, warmup
1, no norm limit), to show what that check let through.  Prints one
line a case, PASS or FAIL, and the check's own line of numbers.
"""
import argparse
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAULTS = {
    "none": None,
    "whole_half": (
        "        return all_reduce(g.clone(), ctx.axes, ctx.sctx), None, None\n",
        "        return 0.5 * all_reduce(g.clone(), ctx.axes, ctx.sctx), "
        "None, None\n"),
    "gather_half": ("        return g.contiguous(), None, None\n",
                    "        return 0.5 * g.contiguous(), None, None\n"),
    "no_dp_sum": (
        "                    g = reduce_scatter(g, d, a, ctx.sctx)\n",
        "                    g = chunk_of(g, d, a, ctx.sctx)\n"),
    "gather_seq_half": (
        "        return reduce_scatter(g, ctx.dim, \"model\", ctx.sctx), None, "
        "None\n",
        "        return 0.5 * reduce_scatter(g, ctx.dim, \"model\", ctx.sctx), "
        "None, None\n"),
    "scatter_seq_half": (
        "        return all_gather(g, ctx.dim, \"model\", ctx.sctx), None, None\n",
        "        return 0.5 * all_gather(g, ctx.dim, \"model\", ctx.sctx), "
        "None, None\n"),
}
OLD_CHECK = (
    ("OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=50)",
     "OptimizerConfig(peak_lr=1e-4, warmup_steps=1, total_steps=10)"),
    ("worst <= 3e-4 and gn_rel <= 1e-4):", "worst <= 3e-4):"))
CASES = (("smollm 3/1 heads (1, 2) context-parallel", "smollm-360m", 2,
          {"num_heads": 3, "num_kv_heads": 1}),
         ("llama (1, 2) head-parallel", "llama3.2-3b", 2, {}),
         ("llama (2, 1) data-parallel", "llama3.2-3b", 1, {}))


def _replace(path, pairs):
    with open(path) as f:
        text = f.read()
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"{path}: the line to change is gone: {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


def _copy(dest, fault, old_check):
    shutil.copytree(os.path.join(ROOT, "src"), os.path.join(dest, "src"),
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dest)
    if FAULTS[fault]:
        _replace(os.path.join(dest, "src", "repro_torch", "dist",
                              "sharding.py"), [FAULTS[fault]])
    if old_check:
        _replace(os.path.join(dest, "chip_smoke.py"), OLD_CHECK)


def _rank(rank, world, tree):
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    for name, arch, model, over in CASES:
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        mesh = make_host_mesh(model=model, device_type="cpu")
        try:
            chip_smoke._mesh_fp32_step(name, cfg, 2, 64, rank, mesh,
                                       device="cpu")
            out[name] = "PASS"
        except AssertionError:
            out[name] = "FAIL"
    return out


def _run_tree(tree):
    """Entry of one tree's subprocess: 2 gloo ranks on the CPU."""
    sys.path[:0] = [os.path.join(tree, "src")]
    from repro_torch.launch.mesh import spawn
    for name, verdict in spawn(_rank, 2, backend="gloo",
                               devices=["cpu", "cpu"], args=(tree,),
                               timeout_s=300)[0].items():
        print(f"RESULT {name}: {verdict}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-check", action="store_true")
    ap.add_argument("--keep", help="build the copies here and keep them")
    args = ap.parse_args()
    base = args.keep or tempfile.mkdtemp(prefix="mesh_faults_")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import torch_mesh_check_faults as T; T._run_tree(sys.argv[2])")
    ok = True
    try:
        for fault in FAULTS:
            tree = os.path.join(base, fault)
            shutil.rmtree(tree, ignore_errors=True)
            _copy(tree, fault, args.old_check)
            proc = subprocess.run(
                [sys.executable, "-c", code, os.path.dirname(__file__),
                 tree], capture_output=True, text=True, timeout=600,
                env=dict(os.environ, PYTHONPATH=os.path.join(tree, "src")))
            print(f"== fault {fault}"
                  + (" (the old check)" if args.old_check else ""))
            for line in proc.stdout.splitlines():
                if "fp32 step" in line or line.startswith("RESULT"):
                    print("  " + line.strip())
            if proc.returncode != 0:
                ok = False
                print(proc.stderr[-3000:])
    finally:
        if not args.keep:
            shutil.rmtree(base, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
