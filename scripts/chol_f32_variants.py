#!/usr/bin/env python3
"""Time variants of the f32 syrk kernel, and the stages of potrf's panel
kernel.

    python3 scripts/chol_f32_variants.py

Builds ``csrc/syrk.cu`` as it is and copies of it with one change each,
made by replacing text (the script raises if a text is missing), one nvcc
each, all started together, into ``kernels/build/variants_chol/``: one
block an SM (no register cap) instead of two, a ring of 4 stages, and
16-wide slabs with a ring of 4.  Each build's f32 kernel is held against
``syrk_ref`` and timed by chip_smoke's ``cuda_ms`` (the card's time) at the
exact path's first update (1, 32256, 512) in its layout, and summed over
the 63 updates of the panel-512 path, beside ``baddbmm``.  Then it builds
``csrc/potrf.cu`` with a ``clock64()`` stamp after each barrier of the
panel kernel, taken by thread 0 of the first block of the panel launch at
j0 = 64, and prints the SM cycles from the kernel's start to each stamp
for a (1, 512, 512) factorization in both dtypes (three calls each).
Prints the card's name and power limit first and one JSON line a build;
exits 1 if a build disagrees.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    SWEEP_B,
    TILE,
    TOL,
    _spd,
    cuda_ms,
    max_err,
    nvidia_smi,
)

_BLOCKS1 = ("__launch_bounds__(kFThreads, kFBlocks)", "__launch_bounds__(kFThreads, 1)")
SYRK_VARIANTS = {
    "source": (),
    "blocks1": (_BLOCKS1,),
    "stages4": (("kFStages = 3;", "kFStages = 4;"), _BLOCKS1),
    "slab16": (("kFK = 32;", "kFK = 16;"), ("kFStages = 3;", "kFStages = 4;")),
}
# the panel kernel's stamps: after grid_wait and the flag check (0), then
# after each barrier of panel_step, in order
STAGES = (
    "start",
    "staged",
    "factor1_l21",
    "quadrant",
    "factor2_rows1",
    "ticket",
    "lkk_written",
    "rows2",
    "end",
)
_PANEL = "__device__ __forceinline__ void panel_step("
_PANEL_END = "__global__ void __launch_bounds__(kPanelThreads, 1)\n    potrf_panel_f64"
_STAMP = (
    "__device__ unsigned long long stamps[32];\n"
    "#define STAMP(n) if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0"
    " && j0 == 64) stamps[n] = clock64();\n"
)
_GETTER = """
extern "C" int potrf_stamps(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, stamps, sizeof(unsigned long long) * 32);
}
"""


def _replace(text: str, old: str, new: str, name: str) -> str:
    if old not in text:
        raise RuntimeError(f"{name}: {old!r} not in the source")
    return text.replace(old, new)


def stamped_potrf(text: str) -> str:
    """potrf.cu with STAMP(k) after the k-th barrier of panel_step."""
    start, end = text.index(_PANEL), text.index(_PANEL_END)
    parts = text[start:end].split("__syncthreads();")
    body = parts[0] + "".join(
        f"__syncthreads(); STAMP({k});" + part for k, part in enumerate(parts[1:], 1)
    )
    anchor = "const int t0 = j0 + w, r0 = t0 + blockIdx.x * kP;\n"
    body = _replace(body, anchor, anchor + "  STAMP(0);\n", "potrf")
    close = body.rstrip().rfind("}")
    body = body[:close] + f"  __syncthreads(); STAMP({len(parts)});\n" + body[close:]
    text = text[:start] + body + text[end:]
    text = _replace(text, "namespace {\n", "namespace {\n" + _STAMP, "potrf")
    return text + _GETTER


def build():
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "variants_chol"
    out_dir.mkdir(parents=True, exist_ok=True)
    header = (_build.CSRC / "dmma.cuh").read_text()
    jobs = {}
    sources = {f"syrk_{n}": ("syrk.cu", c) for n, c in SYRK_VARIANTS.items()}
    sources["potrf_stamped"] = ("potrf.cu", None)
    for name, (fname, changes) in sources.items():
        src_dir = out_dir / name
        src_dir.mkdir(exist_ok=True)
        text = (_build.CSRC / fname).read_text()
        if changes is None:
            text = stamped_potrf(text)
        for old, new in changes or ():
            text = _replace(text, old, new, name)
        (src_dir / fname).write_text(text)
        (src_dir / "dmma.cuh").write_text(header)
        lib = out_dir / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-shared"]
        cmd += [str(src_dir / fname), "-o", str(lib)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        jobs[name] = (lib, proc)
    libs, reports = {}, {}
    for name, (lib, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err.decode()}")
        libs[name] = ctypes.CDLL(str(lib))
        text = out.decode() + err.decode()
        reports[name] = [
            ln.strip() for ln in text.splitlines()
            if "_f32" in ln or "registers" in ln or "spill" in ln
        ]
    return libs, reports


def syrk_call(torch, lib):
    """The build's syrk_f32 as a function of (c, a), as chol_tiles calls it."""
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.syrk_f32
    fn.argtypes = [p, p, p, i, i, i, q, q, q, q, q, p]
    fn.restype = ctypes.c_int

    def run(c, a):
        batch, nb, _ = c.shape
        k = a.shape[2]
        out = torch.empty((batch, nb, nb), dtype=c.dtype, device=c.device)
        stream = torch.cuda.current_stream().cuda_stream
        strides = (c.stride(0), c.stride(1), a.stride(0), a.stride(1), a.stride(2))
        ptrs = (c.data_ptr(), a.data_ptr(), out.data_ptr())
        code = fn(*ptrs, batch, nb, k, *strides, stream)
        if code:
            raise RuntimeError(f"syrk_f32 failed with cudaError_t {code}")
        return out

    return run


def time_syrk(torch, gen, run) -> dict:
    """The first update's time and the 63-update sweep's sum, each held
    against the plain version (the sweep against baddbmm's result)."""
    from repro_torch.kernels import ref

    m, k = (SWEEP_B + 1) * TILE, TILE
    kw = dict(generator=gen, dtype=torch.float32, device="cuda")
    big = torch.randn((1, m, m), **kw)
    pan = torch.randn((1, k, m), **kw)
    c, a = big[:, k:, k:], pan[:, :, : m - k].mT
    err, ok = max_err(torch, run(c, a), ref.syrk_ref(c, a), **TOL["float32"])
    rec = {"first_ms": cuda_ms(torch, lambda: run(c, a)), "first_err": err}
    rec["first_library_ms"] = cuda_ms(
        torch, lambda: torch.baddbmm(c, a, a.mT, alpha=-1.0)
    )
    ms = lib = 0.0
    for nb in range(m - k, 0, -k):
        c, a = big[:, m - nb :, m - nb :], pan[:, :, :nb].mT
        want = torch.baddbmm(c, a, a.mT, alpha=-1.0)
        ok = ok and max_err(torch, run(c, a), want, **TOL["float32"])[1]
        del want
        ms += cuda_ms(torch, lambda: run(c, a), reps=3, warmup=1)
        lib += cuda_ms(
            torch, lambda: torch.baddbmm(c, a, a.mT, alpha=-1.0), reps=3, warmup=1
        )
    rec.update(sweep_ms_sum=ms, sweep_library_ms_sum=lib, ok=ok)
    return rec


def potrf_stages(torch, gen, lib, dtype) -> list:
    """Cycles from the panel kernel's start to each stamp, three calls."""
    p, i = ctypes.c_void_p, ctypes.c_int
    name = "potrf_f64" if dtype == torch.float64 else "potrf_f32"
    fn = getattr(lib, name)
    fn.argtypes = [p, p, p, i, i, p]
    fn.restype = ctypes.c_int
    lib.potrf_stamps.argtypes = [p]
    a = _spd(torch, gen, 1, 512, dtype)
    out = torch.empty_like(a)
    calls = []
    for _ in range(4):
        flag = torch.zeros(2, dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        if fn(a.data_ptr(), out.data_ptr(), flag.data_ptr(), 1, 512, stream):
            raise RuntimeError(f"{name} failed")
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        lib.potrf_stamps(buf)
        calls.append({s: buf[k] - buf[0] for k, s in enumerate(STAGES)})
    return calls[1:]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chol_f32_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi(), flush=True)
    libs, reports = build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ok = True
    for name in SYRK_VARIANTS:
        rec = time_syrk(torch, gen, syrk_call(torch, libs[f"syrk_{name}"]))
        rec = {"syrk": name, **rec, "ptxas": reports[f"syrk_{name}"]}
        ok = ok and rec["ok"]
        print(json.dumps(rec), flush=True)
    for dtype in (torch.float32, torch.float64):
        calls = potrf_stages(torch, gen, libs["potrf_stamped"], dtype)
        print(json.dumps({"potrf_stages": str(dtype), "cycles": calls}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
