#!/usr/bin/env python3
"""Time shapes of the matern_tile kernel's work against each other.

    python3 scripts/matern_tile_variants.py

Builds ``csrc/matern_tile.cu`` as it is and copies of it (with
``matern.cuh``) with one change each, one nvcc each, all started together,
into ``kernels/build/variants/``: other shapes of the work (4 f64 columns a
thread, 8 or 2 rows a block, a grid of what the card holds at once looping
over the rows) and three probes (the CUDA exp in place of exp_neg, no exp,
no sqrt; their values are wrong and not held).  Each runs the main path's
largest GEN panel (16128 x 256, f64) at nu = 1.5 and 2.5 (halfint) and
nu = 1.0 (general), is held against ``matern_tile_ref`` at chip_smoke.py's
``TOL`` and timed by chip_smoke's ``cuda_ms`` (the card's time), in two
rounds, the second in the reverse order; then yardsticks on the same output
(a fill, an exp of the panel's u, the f32 halfint kernel) and the opcode
counts of the f64 nu = 1.5 kernel's SASS.  Prints the card's name and power
limit first and one JSON line a build; exits 1 if a build that is not a
probe disagrees.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import TOL, cuda_ms, main_config, max_err, nvidia_smi  # noqa: E402

# name -> (file, text, replacement) changes to the sources; "product" is
# the source as it is, the "probe" ones only show where the time goes
_RESIDENT_GRID = """  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, matern_tile_kernel<T, NU2, VEC>, kCols * kRows, 0);
  unsigned gy = (unsigned)(sms * per_sm) / gx;
  gy = gy < 1u ? 1u : (gy < rows ? gy : rows);
"""
VARIANTS = {
    "product": (),
    "vec32": (("matern_tile.cu", "kVec = 16 /", "kVec = 32 /"),),
    "rows8": (("matern_tile.cu", "kRows = 4;", "kRows = 8;"),),
    "rows2": (("matern_tile.cu", "kRows = 4;", "kRows = 2;"),),
    "resident_grid": (
        (
            "matern_tile.cu",
            "  const unsigned gy = rows < 65535u ? rows : 65535u;\n",
            _RESIDENT_GRID,
        ),
    ),
    "probe_cuda_exp": (
        ("matern.cuh", "const T e = exp_neg(u);", "const T e = exp_(-u);"),
    ),
    "probe_no_exp": (("matern.cuh", "const T e = exp_neg(u);", "const T e = u;"),),
    "probe_no_sqrt": (
        (
            "matern_tile.cu",
            "matern::sqrt_(d2 > T(0) ? d2 : T(0))",
            "(d2 > T(0) ? d2 : T(0))",
        ),
    ),
}


def build(variants=VARIANTS):
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, changes in variants.items():
        src_dir = out_dir / name
        src_dir.mkdir(exist_ok=True)
        for fname in ("matern_tile.cu", "matern.cuh"):
            text = (_build.CSRC / fname).read_text()
            for target, old, new in changes:
                if target == fname:
                    if old not in text:
                        raise RuntimeError(f"{name}: {old!r} not in {fname}")
                    text = text.replace(old, new)
            (src_dir / fname).write_text(text)
        lib = out_dir / f"libmatern_tile_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-shared"]
        cmd += [str(src_dir / "matern_tile.cu"), "-o", str(lib)]
        jobs[name] = (lib, subprocess.Popen(cmd, stderr=subprocess.PIPE))
    libs = {}
    for name, (lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err.decode()}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


# an instruction line of cuobjdump -sass: its address, a predicate, the opcode
OPCODE = r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)"


def sass_mix(lib_path, pattern=r"matern_tile_kernelIdLi3ELb1EE"):
    """Opcode counts of the f64 nu = 1.5 vector-store kernel in a variant's
    SASS (cuobjdump beside nvcc), the most frequent first."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [tool, "-sass", str(lib_path)], capture_output=True, text=True, timeout=300
    ).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        if not re.search(pattern, part.split("\n", 1)[0]):
            continue
        for line in part.splitlines():
            m = re.match(OPCODE, line)
            if m:
                op = m.group(1).split(".")[0]
                counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def main() -> int:
    import torch

    from repro_torch.kernels import matern_tile, ref

    if not torch.cuda.is_available():
        print("matern_tile_variants: no CUDA device", file=sys.stderr)
        return 2
    print(nvidia_smi(), flush=True)
    libs = build()
    locs, _, _ = main_config(torch, 128, torch.device("cuda"))
    locs = torch.as_tensor(locs, device="cuda")
    la, lb = locs[256:].contiguous(), locs[:256].contiguous()
    inv_range = 1.0 / 0.03
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    nus = (1.5, 1.0, 2.5)
    want = {nu: ref.matern_tile_ref(la, lb, inv_range, 1.0, nu) for nu in nus}
    out = torch.empty((la.shape[0], lb.shape[0]), dtype=torch.float64, device="cuda")
    fns, results, failed = {}, {}, False
    for key, lib in libs.items():
        fn = lib.matern_tile_f64
        fn.argtypes = [p, p, p, i, i, ctypes.c_double, ctypes.c_double, i, p, p]
        fn.restype = ctypes.c_int
        fns[key] = fn
        results[key] = {"build": key}

    def run(key, nu):
        _, nu2, args = matern_tile.launch_args(nu)
        rc = fns[key](
            la.data_ptr(), lb.data_ptr(), out.data_ptr(), la.shape[0],
            lb.shape[0], inv_range, 1.0, nu2, args, stream,
        )
        if rc:
            raise RuntimeError(f"variant {key}: cudaError_t {rc}")

    order = list(libs)
    for rnd, keys in enumerate((order, order[::-1])):
        for key in keys:
            for nu in nus:
                name = matern_tile.instance(nu) + ("25" if nu == 2.5 else "")
                if rnd == 0:
                    out.zero_()
                    run(key, nu)
                    torch.cuda.synchronize()
                    err, ok = max_err(torch, out, want[nu], **TOL["float64"])
                    results[key][f"{name}_max_abs_err"] = err
                    probe = key.startswith("probe") and key != "probe_cuda_exp"
                    failed = failed or (not ok and not probe)
                ms = cuda_ms(torch, lambda: run(key, nu))
                results[key].setdefault(f"{name}_ms", []).append(ms)
    for rec in results.values():
        print(json.dumps(rec), flush=True)
    # yardsticks on the same output: a fill (writes only), the exp of the
    # panel's u into it (one read, one write), and the f32 halfint panel
    u = want[1.5].clone()
    f32 = la.float(), lb.float()
    yard = {
        "fill_ms": cuda_ms(torch, lambda: out.fill_(1.0)),
        "exp_ms": cuda_ms(torch, lambda: torch.exp(u, out=out)),
        "f32_halfint_ms": cuda_ms(
            torch, lambda: matern_tile.matern_tile_cuda(*f32, inv_range, 1.0, nu=1.5)
        ),
    }
    print(json.dumps({"yardsticks": yard}), flush=True)
    lib = libs["product"]._name
    print(json.dumps({"sass_f64_nu15": sass_mix(lib)}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
