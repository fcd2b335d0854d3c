"""Wrapper of the hand-written CUDA kernel ``csrc/matern_tile.cu``.

Counterpart of the Pallas kernel ``repro.kernels.matern_tile.matern_tile``:
C[r, c] = amp * M_nu(||a_r - b_c|| * inv_range), here for any real nu > 0
(the Pallas kernel takes nu in {0.5, 1.5, 2.5}).  The plain version is
``kernels.ref.matern_tile_ref``; ``kernels.ops`` chooses between the two by
the tensors' device.  The order picks one of the kernel's two instances:
``halfint`` (the closed forms) for nu in {0.5, 1.5, 2.5}, ``general`` (K_nu
per element, ``csrc/matern.cuh``) for every other nu.

``general_args`` computes on the host, once per order, what the general
instance needs that depends on nu alone; ``kernels/matern_corr.py`` shares it.
``general_steps`` counts the steps of the general instance's loops on given
distances (the kernel's arithmetic, vectorised), for the operation count of
its bound.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build

HALFINT_NU = (0.5, 1.5, 2.5)
INSTANCES = ("halfint", "general")
# As csrc/matern.cuh: scalars, tables and entries a table; the plain
# version's iteration limits.
N_SCALARS, N_TABLES, TABLE_LEN = 9, 5, 128
TEMME_MAX, CF2_MAX = 200, 400
# Euler–Mascheroni constant (the mu -> 0 limit of gam1).
_EULER_GAMMA = 0.5772156649015328606
_SYMBOLS = {torch.float64: "matern_tile_f64", torch.float32: "matern_tile_f32"}
_SCALAR = {torch.float64: ctypes.c_double, torch.float32: ctypes.c_float}


def instance(nu) -> str:
    """The instance that evaluates order ``nu``; raises unless nu is finite
    and > 0."""
    v = float(nu)
    if not math.isfinite(v) or v <= 0.0:
        raise ValueError(f"the Matérn order must be finite and > 0, got {v}")
    return "halfint" if v in HALFINT_NU else "general"


class GeneralScalars(NamedTuple):
    """What the general instance needs of nu, as core.matern.kv computes it:
    nu = nl + mu with |mu| <= 1/2; gam1, gam2, gampl, gammi as
    ``_chepolish(mu)``; fact = pi mu / sin(pi mu) (1 at mu = 0); lognorm =
    (nu - 1) log 2 + lgamma(nu)."""

    nu: float
    mu: float
    nl: int
    gam1: float
    gam2: float
    gampl: float
    gammi: float
    fact: float
    lognorm: float


def general_scalars(nu: float) -> GeneralScalars:
    """The host scalars of order ``nu``, in float64."""
    nu = float(nu)
    nl = math.floor(nu + 0.5)
    mu = nu - nl
    gampl = math.exp(-math.lgamma(1.0 + mu))
    gammi = math.exp(-math.lgamma(1.0 - mu))
    gam1 = -_EULER_GAMMA if abs(mu) < 1e-6 else (gammi - gampl) / (2.0 * mu)
    gam2 = 0.5 * (gammi + gampl)
    pimu = math.pi * mu
    fact = 1.0 if abs(pimu) < 1e-12 else pimu / math.sin(pimu)
    lognorm = (nu - 1.0) * math.log(2.0) + math.lgamma(nu)
    return GeneralScalars(nu, mu, nl, gam1, gam2, gampl, gammi, fact, lognorm)


@functools.lru_cache(maxsize=64)
def general_args(nu: float) -> np.ndarray:
    """The general instance's host array for order ``nu`` (float64, read
    only): the scalars of ``general_scalars`` in their order, then five
    tables of TABLE_LEN reciprocals indexed by the step i (entry 0 unused):
    1 / i, 1 / (i^2 - mu^2), 1 / (i - mu), 1 / (i + mu) (Temme's series) and
    1 / a_i, a_i = a_{i-1} - 2 (i - 1) from a_1 = mu^2 - 1/4 (Steed's CF2,
    summed in the plain version's order)."""
    s = general_scalars(nu)
    mu = s.mu
    i = np.arange(1, TABLE_LEN, dtype=np.float64)
    tables = np.zeros((N_TABLES, TABLE_LEN))
    tables[0, 1:] = 1.0 / i
    tables[1, 1:] = 1.0 / (i * i - mu * mu)
    tables[2, 1:] = 1.0 / (i - mu)
    tables[3, 1:] = 1.0 / (i + mu)
    a = -(0.25 - mu * mu)
    for k in range(2, TABLE_LEN):
        a = a - 2.0 * (k - 1.0)
        tables[4, k] = 1.0 / a
    out = np.concatenate([np.array(s, dtype=np.float64), tables.reshape(-1)])
    out.flags.writeable = False
    return out


def _tables(nu: float, like: torch.Tensor) -> torch.Tensor:
    arr = general_args(float(nu))[N_SCALARS:].reshape(N_TABLES, TABLE_LEN)
    return torch.tensor(arr, dtype=like.dtype, device=like.device)


def general_steps(u: torch.Tensor, nu: float, chunk: int = 1 << 24):
    """Steps of the general instance's loop for each element of M_nu(u):
    Temme's series where 0 < u <= 2, Steed's CF2 where u > 2, each run with
    the kernel's arithmetic (the tables, the per-element stop) until that
    element has converged.  Returns (steps, temme): int32 and bool tensors
    of u's flat shape; u <= 0 takes no step.  Runs in chunks of ``chunk``
    elements, with one host read a step."""
    s = general_scalars(nu)
    flat = u.reshape(-1)
    tab = _tables(nu, flat)
    eps = torch.finfo(flat.dtype).eps
    steps = torch.zeros(flat.shape, dtype=torch.int32, device=flat.device)
    temme = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
    for start in range(0, flat.numel(), chunk):
        x = flat[start : start + chunk]
        xs = torch.clamp(x, min=1e-30)
        small = (x > 0) & (xs <= 2.0)
        large = (x > 0) & (xs > 2.0)
        temme[start : start + chunk] = small
        out = steps[start : start + chunk]
        out += _temme_steps(s, tab, torch.clamp(xs, max=2.0), small, eps)
        out += _cf2_steps(s, tab, torch.clamp(xs, min=2.0), large, eps)
    return steps, temme


def _temme_steps(s, tab, x, active, eps):
    x2 = 0.5 * x
    d = -torch.log(x2)
    e = s.mu * d
    tiny = torch.abs(e) < 1e-12
    fact2 = torch.where(tiny, 1.0, torch.sinh(e) / torch.where(tiny, 1.0, e))
    ff = s.fact * (s.gam1 * torch.cosh(e) + s.gam2 * fact2 * d)
    ee = torch.exp(e)
    p = 0.5 * ee / s.gampl
    q = 0.5 / (ee * s.gammi)
    c = torch.ones_like(x)
    d2 = x2 * x2
    ksum = ff
    steps = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    active = active.clone()
    for i in range(1, TEMME_MAX + 1):
        if not bool(active.any()):
            break
        fi = float(i)
        if i < TABLE_LEN:
            r_i, r_den, r_m, r_p = tab[0, i], tab[1, i], tab[2, i], tab[3, i]
        else:
            r_i, r_den = 1.0 / fi, 1.0 / (fi * fi - s.mu * s.mu)
            r_m, r_p = 1.0 / (fi - s.mu), 1.0 / (fi + s.mu)
        ff = (fi * ff + p + q) * r_den
        c = c * d2 * r_i
        p = p * r_m
        q = q * r_p
        delk = c * ff
        ksum = ksum + delk
        steps += active
        active &= ~(torch.abs(delk) < torch.abs(ksum) * eps)
    return steps


def _cf2_steps(s, tab, x, active, eps):
    a1 = 0.25 - s.mu * s.mu
    a = -a1
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    delh = d
    q1, q2 = torch.zeros_like(x), torch.ones_like(x)
    q, c = a1 * torch.ones_like(x), a1
    sv = 1.0 + q * delh
    steps = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    active = active.clone()
    for i in range(2, CF2_MAX + 2):
        if not bool(active.any()):
            break
        fi = float(i)
        a = a - 2.0 * (fi - 1.0)
        r_i = tab[0, i] if i < TABLE_LEN else 1.0 / fi
        r_a = tab[4, i] if i < TABLE_LEN else 1.0 / a
        c = -a * c * r_i
        qnew = (q1 - b * q2) * r_a
        q1, q2 = q2, qnew
        q = q + c * qnew
        b = b + 2.0
        d = 1.0 / (b + a * d)
        delh = (b * d - 1.0) * delh
        dels = q * delh
        sv = sv + dels
        steps += active
        active &= ~(torch.abs(dels) < eps * torch.abs(sv))
    return steps


def launch_args(nu):
    """(instance, nu2, host array pointer) of a launch at order ``nu``:
    nu2 = 2 nu and no array for halfint, nu2 = 0 and ``general_args`` for
    general.  Raises on an order the kernels do not take."""
    name = instance(nu)
    v = float(nu)
    if name == "halfint":
        return name, int(round(2.0 * v)), None
    return name, 0, general_args(v).ctypes.data


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its data start on a multiple of one location (two
    elements), else an aligned copy: the kernels read a location as one
    2 * itemsize load."""
    return t if t.data_ptr() % (2 * t.element_size()) == 0 else t.clone()


def _fn(dtype: torch.dtype):
    fn = getattr(_build.library(), _SYMBOLS[dtype])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, _SCALAR[dtype], _SCALAR[dtype], i, p, p]
    fn.restype = ctypes.c_int
    return fn


def matern_tile_cuda(
    locs_a: torch.Tensor, locs_b: torch.Tensor, inv_range, amp, *, nu
) -> torch.Tensor:
    """Launch the CUDA kernel on (n, 2) and (m, 2) location panels.

    Both panels are contiguous CUDA tensors of one dtype (float32 or
    float64) on one device; ``nu`` is any finite order > 0 (a float or a
    0-d tensor).  Returns a new (n, m) tensor.  Raises on anything the
    kernel does not take and if the launch fails.
    """
    name, nu2, args = launch_args(nu)
    for label, t in (("locs_a", locs_a), ("locs_b", locs_b)):
        if t.device.type != "cuda":
            raise ValueError(f"{label} must be a CUDA tensor, got {t.device}")
        if t.dim() != 2 or t.shape[1] != 2:
            raise ValueError(f"{label} must have shape (n, 2), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if locs_a.device != locs_b.device:
        raise ValueError("locs_a and locs_b lie on different devices")
    dtype = locs_a.dtype
    if dtype not in _SYMBOLS or locs_b.dtype != dtype:
        raise ValueError(
            f"matern_tile takes float32 or float64 panels of one dtype, "
            f"got {locs_a.dtype} and {locs_b.dtype}"
        )
    n, m = locs_a.shape[0], locs_b.shape[0]
    if max(n, m) >= 2**31 or n * m >= 2**62:
        raise ValueError(f"panel sizes ({n}, {m}) are too large")
    out = torch.empty((n, m), dtype=dtype, device=locs_a.device)
    if n == 0 or m == 0:
        return out
    locs_a, locs_b = aligned(locs_a), aligned(locs_b)
    with torch.cuda.device(locs_a.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (locs_a.data_ptr(), locs_b.data_ptr(), out.data_ptr())
        scalars = (float(inv_range), float(amp), nu2, args)
        rc = _fn(dtype)(*ptrs, n, m, *scalars, stream)
    _build.check(rc, "matern_tile")
    matern_tile_cuda.launches += 1
    matern_tile_cuda.launches_by_instance[name] += 1
    return out


matern_tile_cuda.launches = 0
matern_tile_cuda.launches_by_instance = dict.fromkeys(INSTANCES, 0)
