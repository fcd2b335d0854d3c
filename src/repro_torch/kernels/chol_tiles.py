"""Wrappers of the hand-written CUDA kernels ``csrc/potrf.cu``,
``csrc/trsm.cu`` and ``csrc/syrk.cu``: the POTRF, TRSM and SYRK tile tasks
of the blocked Cholesky.

Counterparts of the Pallas kernels ``repro.kernels.chol_tiles.potrf``,
``.trsm`` and ``.syrk``.  The plain versions are ``kernels.ref.potrf_ref``,
``trsm_ref`` and ``syrk_ref``; ``kernels.ops`` chooses by the tensors'
device.  The dtype picks one of each kernel's two instances: float64 runs
``dmma_f64`` (every product on the FP64 tensor cores; potrf and, past 512
rows, trsm blocked over the card), float32 ``fma_f32`` (on the FP32 CUDA
cores: potrf and trsm the f64 instances' blocked schedules, syrk 128 x 128
tiles of 8 x 8 outputs a thread).  The host-side plans (trsm's strip
width, super-block, update tile and row split, of each dtype; the f64
syrk's tile edge) are the plain functions ``trsm_plan`` and
``syrk_tile``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# dtype -> (potrf instance, its C symbol)
_POTRF = {
    torch.float64: ("dmma_f64", "potrf_f64"),
    torch.float32: ("fma_f32", "potrf_f32"),
}
_TRSM = {
    torch.float64: ("dmma_f64", "trsm_f64"),
    torch.float32: ("fma_f32", "trsm_f32"),
}
_SYRK = {
    torch.float64: ("dmma_f64", "syrk_f64"),
    torch.float32: ("fma_f32", "syrk_f32"),
}
# syrk: the smallest output tile edge of the two instances, whose grid
# bounds the shapes the kernels take
SYRK_TILE = 64
# dmma_f64 syrk: output tile edges
SYRK_DMMA_TILES = (128, 64)
# trsm, both instances: diagonal block (its inverses' edge), rows of one
# strip launch, the strip widths, and the update tiles between strip
# launches.
TRSM_BLOCK = 64
TRSM_SUPER = 512
TRSM_COLS = (64, 32, 16, 8)
TRSM_UPDATE_TILES = (128, 64)


def _instance(kernel: str, table: dict, dtype: torch.dtype) -> str:
    if dtype not in table:
        raise ValueError(f"{kernel} takes float32 or float64, got {dtype}")
    return table[dtype][0]


def potrf_instance(dtype: torch.dtype) -> str:
    """Name of the potrf instance that takes ``dtype``; raises on any other."""
    return _instance("potrf", _POTRF, dtype)


def trsm_instance(dtype: torch.dtype) -> str:
    """Name of the trsm instance that takes ``dtype``; raises on any other."""
    return _instance("trsm", _TRSM, dtype)


def syrk_instance(dtype: torch.dtype) -> str:
    """Name of the syrk instance that takes ``dtype``; raises on any other."""
    return _instance("syrk", _SYRK, dtype)


def _potrf_fn(dtype: torch.dtype):
    fn = getattr(_build.library(), _POTRF[dtype][1])
    p, i = ctypes.c_void_p, ctypes.c_int
    # a, out, the scratch (failure flags, tickets), batch, nb, stream
    fn.argtypes = [p, p, p, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _trsm_fn(dtype: torch.dtype):
    fn = getattr(_build.library(), _TRSM[dtype][1])
    p, i = ctypes.c_void_p, ctypes.c_int
    # lo, b, out, dinv; batch, nb, r, lo_batch; the plan; stream
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _syrk_fn(dtype: torch.dtype):
    fn = getattr(_build.library(), _SYRK[dtype][1])
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # the f64 instance takes its tile edge before the stream
    tile = [i] if dtype == torch.float64 else []
    fn.argtypes = [p, p, p, i, i, i, q, q, q, q, q, *tile, p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, t: torch.Tensor, dtype, device, table) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype not in table or (dtype is not None and t.dtype != dtype):
        raise ValueError(f"{name} must be float32 or float64 of one dtype")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def potrf_cuda(a: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a (B, nb, nb) batch of SPD tiles.

    ``a`` is a contiguous float32 or float64 CUDA tensor; only its lower
    triangle is read.  Returns a new tensor holding the lower factors,
    zeros above the diagonal; a tile whose factorization meets a pivot that
    is not positive and finite comes back all NaN.  Both instances issue
    their whole sequence of launches in one call, on the current stream,
    without a host sync.  Raises on anything the kernel does not take and if
    a launch fails.
    """
    _check_cuda("a", a, None, None, _POTRF)
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"a must have shape (B, nb, nb), got {tuple(a.shape)}")
    b, nb, _ = a.shape
    if nb * nb >= 2**31 or b > 65535:
        raise ValueError(f"a batch of {b} tiles of size {nb} is too large")
    out = torch.empty_like(a)
    if b == 0 or nb == 0:
        return out
    name = potrf_instance(a.dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        # per tile: its failure flag, then its panel launches' ticket
        scratch = torch.zeros(2 * b, dtype=torch.int32, device=a.device)
        ptrs = (a.data_ptr(), out.data_ptr(), scratch.data_ptr())
        code = _potrf_fn(a.dtype)(*ptrs, b, nb, stream)
    _build.check(code, f"potrf ({name})")
    potrf_cuda.launches += 1
    potrf_cuda.launches_by_instance[name] += 1
    return out


potrf_cuda.launches = 0
potrf_cuda.launches_by_instance = {name: 0 for name, _ in _POTRF.values()}


def trsm_plan(
    batch: int, nb: int, r: int, sms: int, dtype: torch.dtype = torch.float64
) -> tuple[int, int, int, int]:
    """(strip columns, super-block rows, update tile, row split) of the
    trsm instance that takes ``dtype``.

    A strip block solves up to 64 right-hand-side columns, halved (down to
    8) while half of them would be padding for a small ``r`` or while the
    grid of (column strips x batch) would leave half of the card's ``sms``
    streaming multiprocessors idle.  (Each strip block streams all of L
    through L2, so more, narrower strips cost L2 traffic: at the panel
    TRSM, 126 strips of 64 beat 252 of 32.)  One strip launch solves a
    super-block of at most 512 rows (all of nb <= 512).  Where 8-column
    strips, each given a cluster of blocks, one a 64-row block row of the
    super-block, would still fill at most half the card's SMs, the row
    split is 1 (r = 1: alpha; with more clusters their chains of cluster
    barriers lose to one block a strip).  Past one super-block
    the updates between them take 128 x 128 tiles, or 64 x 64 ones where
    the first update's 128 x 128 grid would fill under two waves of the
    card (0 when nb <= 512: no update runs).  Both instances take the same
    plan.
    """
    trsm_instance(dtype)
    cols = TRSM_COLS[0]
    while cols > TRSM_COLS[-1] and cols // 2 >= r:
        cols //= 2
    while cols > TRSM_COLS[-1] and -(-r // cols) * batch < sms // 2:
        cols //= 2
    super_rows = min(TRSM_SUPER, -(-nb // TRSM_BLOCK) * TRSM_BLOCK)
    strips = -(-r // cols) * batch
    narrow = cols == TRSM_COLS[-1]
    split = int(narrow and strips * (super_rows // TRSM_BLOCK) <= sms // 2)
    tile = 0
    if nb > super_rows:
        big = TRSM_UPDATE_TILES[0]
        grid = -(-(nb - super_rows) // big) * -(-r // big) * batch
        tile = big if grid >= 2 * sms else TRSM_UPDATE_TILES[1]
    return cols, super_rows, tile, split


def trsm_cuda(lo: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: X = L^{-1} B for lower L.

    ``lo`` is (B, nb, nb), or (1, nb, nb) to use one factor for the whole
    batch; ``b`` is (B, nb, r).  Both are contiguous CUDA tensors of one
    dtype (float32 or float64) on one device; only the lower triangle of
    ``lo`` is read.  Returns a new (B, nb, r) tensor.  Both instances issue
    their launches (as ``trsm_plan`` lays them out) on the current stream
    without a host sync.  Raises on anything the kernel does not take and if a launch
    fails.
    """
    _check_cuda("b", b, None, None, _TRSM)
    _check_cuda("lo", lo, b.dtype, b.device, _TRSM)
    if b.dim() != 3:
        raise ValueError(f"b must have shape (B, nb, r), got {tuple(b.shape)}")
    batch, nb, r = b.shape
    if lo.dim() != 3 or lo.shape[1:] != (nb, nb) or lo.shape[0] not in (1, batch):
        raise ValueError(
            f"lo has shape {tuple(lo.shape)}, expected (1 or {batch}, {nb}, {nb})"
        )
    if batch > 65535 or nb * nb >= 2**31 or nb * r >= 2**31:
        raise ValueError(f"trsm of shape {tuple(b.shape)} is too large")
    out = torch.empty_like(b)
    if batch == 0 or nb == 0 or r == 0:
        return out
    name = trsm_instance(b.dtype)
    sms = torch.cuda.get_device_properties(b.device).multi_processor_count
    plan = trsm_plan(batch, nb, r, sms, b.dtype)
    nblk = -(-nb // TRSM_BLOCK)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        dinv = torch.empty(
            (lo.shape[0], nblk, TRSM_BLOCK, TRSM_BLOCK), dtype=b.dtype, device=b.device
        )
        ptrs = (lo.data_ptr(), b.data_ptr(), out.data_ptr(), dinv.data_ptr())
        code = _trsm_fn(b.dtype)(*ptrs, batch, nb, r, lo.shape[0], *plan, stream)
    _build.check(code, f"trsm ({name})")
    trsm_cuda.launches += 1
    trsm_cuda.launches_by_instance[name] += 1
    return out


trsm_cuda.launches = 0
trsm_cuda.launches_by_instance = {name: 0 for name, _ in _TRSM.values()}


def syrk_grid(batch: int, nb: int, k: int, tile: int = SYRK_TILE) -> tuple[int, int]:
    """The syrk launch grid (lower-triangle output tiles of edge ``tile``,
    batch); raises for a shape the kernel cannot index.  Element offsets are
    64-bit, so nb^2 may pass 2^31; the tile count must fit grid.x and the
    batch grid.y."""
    side = -(-nb // tile)
    tiles = side * (side + 1) // 2
    if batch > 65535 or tiles >= 2**31 or nb >= 2**31 or k >= 2**31:
        raise ValueError(f"syrk of shape ({batch}, {nb}, {k}) is too large")
    return tiles, batch


def syrk_tile(batch: int, nb: int, sms: int) -> int:
    """Output tile edge of the dmma_f64 syrk: 128, or 64 where the 128 x 128
    grid would fill under two waves of the card's ``sms`` SMs."""
    big, small = SYRK_DMMA_TILES
    tiles = syrk_grid(batch, nb, 0, big)[0]
    return big if tiles * batch >= 2 * sms else small


def syrk_cuda(c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: C - A A^T for a batch.

    ``c`` is (B, nb, nb) and ``a`` (B, nb, k), CUDA tensors of one dtype
    (float32 or float64) on one device.  ``c`` may be a view whose rows are
    strided (its last dimension must have unit stride), so the trailing
    block of a larger matrix is read in place; ``a`` may be row-major or
    column-major in its last two dimensions.  Returns a new contiguous
    (B, nb, nb) tensor holding the full square.  Raises on anything the
    kernel does not take and if the launch fails.
    """
    for name, t in (("c", c), ("a", a)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if c.dtype not in _SYRK or a.dtype != c.dtype or a.device != c.device:
        raise ValueError("c and a must be float32 or float64 of one dtype and device")
    if c.dim() != 3 or c.shape[1] != c.shape[2]:
        raise ValueError(f"c must have shape (B, nb, nb), got {tuple(c.shape)}")
    batch, nb, _ = c.shape
    if a.dim() != 3 or a.shape[:2] != (batch, nb):
        raise ValueError(f"a has shape {tuple(a.shape)}, expected ({batch}, {nb}, k)")
    k = a.shape[2]
    if nb > 1 and c.stride(2) != 1:
        raise ValueError("c must have unit stride along its last dimension")
    a_rs, a_cs = a.stride(1), a.stride(2)
    if k > 1 and nb > 1 and a_cs != 1 and a_rs != 1:
        raise ValueError("a must be row-major or column-major in its last two dims")
    syrk_grid(batch, nb, k)
    out = torch.empty((batch, nb, nb), dtype=c.dtype, device=c.device)
    if batch == 0 or nb == 0:
        return out
    name = syrk_instance(c.dtype)
    if k <= 1:
        a_cs = 1
    tile = []
    if c.dtype == torch.float64:
        sms = torch.cuda.get_device_properties(c.device).multi_processor_count
        tile = [syrk_tile(batch, nb, sms)]
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (c.data_ptr(), a.data_ptr(), out.data_ptr())
        strides = (c.stride(0), c.stride(1), a.stride(0), a_rs, a_cs)
        code = _syrk_fn(c.dtype)(*ptrs, batch, nb, k, *strides, *tile, stream)
    _build.check(code, f"syrk ({name})")
    syrk_cuda.launches += 1
    syrk_cuda.launches_by_instance[name] += 1
    return out


syrk_cuda.launches = 0
syrk_cuda.launches_by_instance = {name: 0 for name, _ in _SYRK.values()}
