#!/usr/bin/env python3
"""Which collective transports the multi-device forms can use on one GPU.

    python3 scripts/mesh_transport.py [--world 4]

Runs on a machine with one CUDA device, from the root of a checkout.  Prints
one JSON line for each check:

  * ``nccl_one_device``: W ranks over NCCL on the one device, each calling
    all_reduce; NCCL refuses two ranks on one device, and the line quotes
    the error the rank raised;
  * ``nccl_single_rank``: one rank over NCCL, each collective on a CUDA
    tensor (the production backend, as chip_smoke's mesh phase runs it);
  * ``gloo_cuda``: W ranks over gloo, broadcast, all_reduce and all_gather
    each on CUDA tensors, checked against the values sent, and timed at
    4 KiB, 4 MiB and 64 MiB a rank (ms a call, median of 5, host clock
    after a synchronize): the stand-in transport of several ranks on one
    card, and whether each collective takes CUDA tensors (else
    ``launch.mesh`` would have to stage it through the host);
  * ``gloo_cuda_dtypes``: W ranks over gloo on a ("pod", "data", "model")
    mesh, all_reduce and all_gather of bfloat16, float32 and int32 CUDA
    tensors, on the whole group and on the groups of ("model",) and
    ("pod", "data") (``launch.mesh.axis_group``), checked against the
    values sent: the dtypes and groups the sharded LM's collectives use.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# float64 elements of each timed size
SIZES = {"4KiB": 512, "4MiB": 512 * 1024, "64MiB": 8 * 1024 * 1024}


def _timed(torch, fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def collectives_rank(mesh, timed: bool) -> dict:
    """Each collective on CUDA tensors: whether it ran, its values, its time."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as lm

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": rank, "backend": dist.get_backend()}
    checks = {
        "broadcast": (
            lambda t: lm.broadcast_(t, 0),
            lambda t: t.fill_(rank + 1.0),
            lambda t: bool((t == 1.0).all()),
        ),
        "all_reduce": (
            lambda t: lm.all_reduce_(t),
            lambda t: t.fill_(rank + 1.0),
            lambda t: bool((t == world * (world + 1) / 2).all()),
        ),
        "all_gather": (
            lambda t: lm.all_gather(t),
            lambda t: t.fill_(rank + 1.0),
            None,
        ),
    }
    for name, (run, fill, good) in checks.items():
        rec = {}
        try:
            t = fill(torch.empty(SIZES["4KiB"], dtype=torch.float64, device=dev))
            res = run(t)
            if name == "all_gather":
                rec["ok"] = all(
                    bool((p == r + 1.0).all()) and p.is_cuda for r, p in enumerate(res)
                )
            else:
                rec["ok"] = good(t) and t.is_cuda
            if timed:
                rec["ms"] = {}
                for tag, n in SIZES.items():
                    t = fill(torch.empty(n, dtype=torch.float64, device=dev))
                    rec["ms"][tag] = _timed(torch, lambda: run(t))
        except Exception as exc:  # the record says which collective failed
            rec = {"ok": False, "error": f"{type(exc).__name__}: {exc}"[:600]}
        out[name] = rec
    return out


def dtypes_rank(mesh) -> dict:
    """all_reduce and all_gather of each dtype on CUDA tensors, over the
    whole group and two axis groups; a record a (dtype, group)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as lm

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": dist.get_rank(), "coordinate": list(mesh.get_coordinate())}
    groups = {"world": None, "model": ("model",), "pod_data": ("pod", "data")}
    for gname, axes in groups.items():
        group = None if axes is None else lm.axis_group(mesh, axes)
        size = dist.get_world_size(group)
        me = dist.get_rank(group)
        for dt in (torch.bfloat16, torch.float32, torch.int32):
            key = f"{gname}:{str(dt).split('.')[-1]}"
            try:
                t = torch.full((1024,), me + 1, dtype=dt, device=dev)
                lm.all_reduce_(t, group=group)
                parts = lm.all_gather(torch.full((8,), me + 1, dtype=dt, device=dev),
                                      group=group)
                ok = bool((t == size * (size + 1) // 2).all()) and t.is_cuda
                ok = ok and all(bool((p == i + 1).all()) for i, p in enumerate(parts))
                out[key] = {"ok": ok, "size": size}
            except Exception as exc:  # the record says which failed
                out[key] = {"ok": False, "error": f"{type(exc).__name__}: {exc}"[:400]}
    return out


def nccl_rank(mesh) -> dict:
    import torch

    from repro_torch.launch import mesh as lm

    t = torch.ones(4, dtype=torch.float64, device="cuda")
    lm.all_reduce_(t)
    torch.cuda.synchronize()
    return {"sum": float(t[0])}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args()

    import torch

    from repro_torch.launch.mesh import spawn_ranks

    if not torch.cuda.is_available():
        print("mesh_transport: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    emit({"torch": torch.__version__, "cuda": torch.version.cuda, "gpu": smi,
          "device_count": torch.cuda.device_count()})
    res = spawn_ranks(dtypes_rank, 4, backend="gloo", device_type="cuda",
                      timeout_s=120.0, mesh_shape=(2, 1, 2))
    emit({"check": "gloo_cuda_dtypes", "world": 4, "results": res})
    dtypes_ok = all(v["ok"] for r in res for k, v in r.items() if ":" in k)
    emit({"gloo_takes_the_lm_dtypes": dtypes_ok})
    try:
        res = spawn_ranks(nccl_rank, args.world, backend="nccl", device_type="cuda",
                          timeout_s=60.0)
        emit({"check": "nccl_one_device", "world": args.world, "refused": False,
              "results": res})
    except RuntimeError as exc:
        text = str(exc)
        lines = [ln for ln in text.splitlines() if "Error" in ln or "rror:" in ln]
        emit({"check": "nccl_one_device", "world": args.world, "refused": True,
              "error_lines": lines[-6:], "tail": text[-1500:]})
    res = spawn_ranks(collectives_rank, 1, args=(False,), backend="nccl",
                      device_type="cuda", timeout_s=60.0)
    emit({"check": "nccl_single_rank", "results": res})
    res = spawn_ranks(collectives_rank, args.world, args=(True,), backend="gloo",
                      device_type="cuda", timeout_s=120.0)
    emit({"check": "gloo_cuda", "world": args.world, "results": res})
    ok = all(r[c]["ok"] for r in res for c in ("broadcast", "all_reduce", "all_gather"))
    emit({"gloo_takes_cuda_tensors": ok})
    return 0


if __name__ == "__main__":
    sys.exit(main())
