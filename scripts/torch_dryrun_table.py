"""Print the dry run's per-rank table (``PERF.md``) from its results file.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    python scripts/torch_dryrun_table.py [results/dryrun_torch.json] [16x16]

One row per cell of the layout: the rank's TFLOP (of it the kernels'),
GB its ops and kernels move, collective GB by kind (summed over axes),
peak GB of its storages and the roofline's dominant term on the H100.
Every figure is computed on the CPU from shapes.
"""
import json
import sys

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "param_gather")


def main(path: str = "results/dryrun_torch.json", mesh: str = "16x16"):
    cells = json.load(open(path))["cells"]
    print("| Cell | TFLOP (kernels) | GB moved | "
          + " | ".join(f"{k} GB" for k in KINDS)
          + " | peak GB | dominant (s) |")
    print("| --- " * (5 + len(KINDS)) + "|")
    for key in sorted(cells):
        rec = cells[key]
        arch, shape, m = key.split("|")
        if m != mesh or rec["status"] != "ok":
            continue
        rl, cost = rec["roofline"], rec["cost"]
        coll = {k: 0.0 for k in KINDS}
        for name, b in rec["collectives"]["per_kind"].items():
            coll[name.split("/")[0]] += b
        dom = rl["dominant"]
        secs = rl[{"compute": "compute_s", "memory": "memory_s",
                   "collective": "collective_s"}[dom]]
        print(f"| {arch} × {shape} | {rl['flops'] / 1e12:.2f} "
              f"({cost['kernel_flops'] / 1e12:.2f}) | "
              f"{rl['hbm_bytes'] / 1e9:.0f} | "
              + " | ".join(f"{coll[k] / 1e9:.2f}" for k in KINDS)
              + f" | {rec['memory']['peak_size_in_bytes'] / 1e9:.1f} | "
              f"{dom} ({secs:.3f}) |")


if __name__ == "__main__":
    main(*sys.argv[1:])
