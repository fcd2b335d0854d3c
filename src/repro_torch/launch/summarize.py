"""Summarize the dry-run's JSON records into a markdown table (counterpart
of ``repro.launch.summarize``).

  python -m repro_torch.launch.summarize [--dir results/dryrun_torch] [--mesh pod|multipod|all]

One row a (cell, mesh): the peak GB a rank and whether it fits the card's
80 GB, FLOPs, bytes and collective bytes a rank (by mesh axis), the three
roofline terms and the one that binds, the useful-FLOPs ratio and the
roofline fraction, and the trace's seconds; a cell that failed to trace
is a row that says so.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from .dryrun import RESULTS_DIR


def load_records(directory: str):
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fraction(rec):
    """Roofline fraction: useful time / modelled execution time (the
    largest of the three terms: perfect overlap); useful time = MODEL_FLOPS
    / (chips x the peak at the cell's compute dtype)."""
    from .roofline import peak_flops

    t_exec = max(rec["compute_s"], rec["memory_s"], rec["collective_s"])
    peak = peak_flops(rec.get("compute_dtype", "bfloat16"))
    t_useful = rec["model_flops_global"] / (rec["chips"] * peak)
    return t_useful / t_exec if t_exec > 0 else 0.0


def _axes(rec) -> str:
    by_axis = rec.get("collective_breakdown", {}).get("by_axis", {})
    return ", ".join(f"{k} {v:.3g}" for k, v in sorted(by_axis.items())) or "none"


def markdown_table(recs, mesh: str | None = "pod", variant: str | None = None):
    rows = [
        r for r in recs
        if (mesh is None or r["mesh"] == mesh)
        and (variant is None or r.get("variant") == variant)
    ]
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    out = [
        "| arch | shape | mesh | peak GB | fits | FLOPs | bytes | collective bytes "
        "by axis | compute s | memory s | collective s | binds | useful | roofline "
        "frac | trace s |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("status") != "ok":
            err = r.get("error", "?").replace("|", "/")[:120]
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | failed: {err} "
                "| | | | | | | | | | | |"
            )
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['peak_bytes'] / 1e9:.2f} | {'yes' if r['fits'] else '**no**'} "
            f"| {r['hlo_flops_per_chip']:.3e} | {r['hlo_bytes_per_chip']:.3e} "
            f"| {_axes(r)} | {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | {r['dominant']} "
            f"| {r['useful_flops_ratio']:.3f} | {fraction(r):.3f} "
            f"| {r['trace_s']:.1f} |"
        )
    return "\n".join(out)


def _short(r) -> str:
    """One run's numbers in one cell: peak GB (fits), FLOPs, bytes,
    collective bytes by axis, the binding term, trace s; or the failure."""
    if r is None:
        return "not run"
    if r.get("status") != "ok":
        return "failed: " + r.get("error", "?").replace("|", "/")[:80]
    by_axis = r.get("collective_breakdown", {}).get("by_axis", {})
    axes = " ".join(f"{k.replace('data+model', 'd+m')} {v:.2g}"
                    for k, v in sorted(by_axis.items()))
    fits = "" if r["fits"] else " **no**"
    return (f"{r['peak_bytes'] / 1e9:.1f}{fits} / {r['hlo_flops_per_chip']:.2g} / "
            f"{r['hlo_bytes_per_chip']:.2g} / {axes or '0'} / {r['dominant'][:4]} / "
            f"{r['trace_s']:.0f}")


def paired_table(recs, variant: str | None = None) -> str:
    """Every cell's two meshes side by side: "pod" and "multipod", each
    "peak GB (**no** past 80) / FLOPs / bytes / collective bytes by axis /
    binding term / trace s" a rank."""
    runs = {}
    for r in recs:
        if variant is None or r.get("variant") == variant:
            runs[(r["arch"], r["shape"], r["mesh"])] = r
    cells = sorted({(a, s) for a, s, _ in runs})
    out = ["| cell | pod (16 x 16) | multipod (2 x 16 x 16) |", "|---|---|---|"]
    for a, s in cells:
        out.append(f"| {a} {s} | {_short(runs.get((a, s, 'pod')))} "
                   f"| {_short(runs.get((a, s, 'multipod')))} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RESULTS_DIR)
    ap.add_argument("--mesh", default="all", help="pod, multipod or all")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--paired", action="store_true",
                    help="one row a cell, its two meshes side by side")
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    print(f"{len(recs)} records")
    if args.paired:
        print(paired_table(recs, args.variant))
    else:
        print(markdown_table(recs, None if args.mesh == "all" else args.mesh,
                             args.variant))


if __name__ == "__main__":
    main()
