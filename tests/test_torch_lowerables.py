"""The port's lowerables registry (repro_torch.lowerables) and its
constructors (core.dist_cholesky, core.dist_tlr, serving.cokrige_service)
against the reference's (repro.lowerables) on the CPU.

The names, each built cell's input specs and its in-place contract equal
the reference's, at the test size and at the four production geostat
shapes, a test a (shape, target).  (The suite's workers start files
with more tests first: with its 49 tests this file, whose cost is the
reference's compiles, runs early, not beside the seed's long end-to-end
files, which start last and which it would slow.)  Each of the eight
cells runs at n = 512 (p = 2) on a one-rank CPU
mesh (a gloo process group of one, made and destroyed by the module's
fixture) against the reference's ``jax.jit(fn)`` on a 1 x 1 ``Mesh`` (Auto
axes: the reference's mesh forms under this JAX's Explicit default fail,
ROADMAP Queue 3), chained as the serving path chains them: compress into
factorize, fit into predict.  Twice:

* in float64, both packages' constructors called directly with float64
  parameters and inputs (the registry fixes float32), on tiles of 128, at
  1e-9 with equal ranks; the truncated factors are compared as the tiles U V^T they
  represent (an SVD's vectors are unique only up to sign and rotation
  within equal singular values);
* through both registries in float32, at the gaps measured here (each
  under the tolerance stated beside its cell): the four cells that do not
  run the whole TLR factorization in this process (F32_TOL), the four that
  do with the reference's side in a subprocess pinned to two cores
  (F32_TLR_TOL, ``ref_f32_tlr``).

The locations are a jittered grid of spacing 0.1, Morton-ordered: at the
registry's range a = 0.09 and nu22 = 2.5 a uniform draw of 512 points in the
unit square gives a Sigma whose float32 factorization breaks down.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.lowerables as jl  # noqa: E402
from repro.configs.base import GEOSTAT_SHAPES as J_SHAPES  # noqa: E402
from repro.core import dist_cholesky as jdc  # noqa: E402
from repro.core import dist_tlr as jdt  # noqa: E402
from repro.core.covariance import MaternParams as JParams  # noqa: E402
from repro.core.covariance import build_sigma as j_build_sigma  # noqa: E402
from repro.serving import cokrige_service as jcs  # noqa: E402
from repro_torch import lowerables as tl  # noqa: E402
from repro_torch.configs.base import GEOSTAT_SHAPES, GeoStatShape  # noqa: E402
from repro_torch.core import dist_cholesky as tdc  # noqa: E402
from repro_torch.core import dist_tlr as tdt  # noqa: E402
from repro_torch.core.covariance import MaternParams, morton_order  # noqa: E402
from repro_torch.serving import cokrige_service as tcs  # noqa: E402

N, P = 512, 2
M = N * P
SHAPE = GeoStatShape("t512", N, P, "mle")
NB, KMAX = 128, 32  # the float64 chains (the registry: 64, 32 at m = 1024)
PANEL = 512  # the registry's exact panel at m = 1024
F64_TOL = 1e-9
# float32 through both registries: the largest gap measured here over the
# cell's outputs, relative to the largest magnitude, and the limit held
# (about 10x the measured gap)
F32_TOL = {
    "dist_loglik_lowerable": 1e-4,  # measured 1.25e-5
    "dist_tlr_gen_lowerable": 1e-5,  # 1.11e-6
    "dist_tlr_compress_lowerable": 3e-5,  # diag 2.56e-6, tiles 2.70e-6
    "dist_cokrige_lowerable": 1e-3,  # 1.14e-4
}
# The cells that run the whole TLR factorization (pipeline, factorize,
# serve_fit, serve_predict), chained, the reference's side in a subprocess
# (``ref_f32_tlr``); the same measure
F32_TLR_TOL = {
    "pipeline": 3e-4,  # loglik 2.59e-5
    "compress_factorize": 3e-4,  # loglik 2.59e-5, the factor's diagonal 1.90e-5
    "serving": 2e-3,  # alpha 1.64e-4, mean 2.10e-4, variance 4.38e-6
}


@pytest.fixture(scope="module")
def meshes():
    """(the port's one-rank CPU mesh, the reference's 1 x 1 Mesh)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    tmp = tempfile.mkdtemp(prefix="lowerables-")
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1,
    )
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        jmesh = jax.sharding.Mesh(
            np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model")
        )
        yield mesh, jmesh
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    g = np.stack(np.meshgrid(np.arange(23), np.arange(23)), -1).reshape(-1, 2)[:N]
    locs = g * 0.1 + rng.uniform(-0.03, 0.03, size=(N, 2))
    locs = locs[morton_order(locs)]
    z = rng.standard_normal(M)
    pred = rng.uniform(0.0, 2.2, size=(512, 2))
    return locs, z, pred


def _rel(want, got) -> float:
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float64)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-300))


def _tiles(u, v):
    """The tiles U V^T of pair-major factors."""
    return np.einsum("snk,smk->snm", np.asarray(u), np.asarray(v))


def _t(x, dtype):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _spec_list(specs):
    return [(tuple(s.shape), str(s.dtype).split(".")[-1]) for s in specs]


@pytest.mark.parametrize("name", jl.names())
@pytest.mark.parametrize("shape", [SHAPE, *GEOSTAT_SHAPES.values()], ids=lambda s: s.name)
def test_names_specs_and_in_place_contract_equal_the_reference(meshes, shape, name):
    """Each target at the test size and each production shape."""
    mesh, jmesh = meshes
    assert tl.names() == jl.names()
    jshape = J_SHAPES.get(shape.name, shape)
    jc, tc = jl.build(name, jshape, jmesh), tl.build(name, shape, mesh)
    assert list(jc) == list(tc)
    for cell in jc:
        want, got = jc[cell], tc[cell]
        assert _spec_list(got.specs) == _spec_list(want.specs), cell
        assert got.donate_argnums == want.donate_argnums
        assert got.matrix_dim == want.matrix_dim
        assert len(got.in_shardings) == len(got.specs)
        assert got.config is None
    if name == "dist_loglik_lowerable":
        with pytest.raises(KeyError, match="dtype policy"):
            tl.build(name, shape, mesh, dtype_policy="mixed_f32")


# ---------------------------------------------------------------------------
# float64: the constructors called directly
# ---------------------------------------------------------------------------


def _f64_params():
    kw = dict(a=0.09, nu11=0.5, nu22=2.5, beta=0.5)
    return (
        JParams.bivariate(**kw, dtype=jnp.float64),
        MaternParams.bivariate(**kw, dtype=torch.float64, device="cpu"),
    )


TLR_KW = dict(tile_size=NB, max_rank=KMAX, tol=1e-7, nugget=1e-8)
F64 = dict(dtype=torch.float64)


def _run_f64(chain, mesh, jmesh, data):
    locs, z, pred = data
    jp, tp = _f64_params()
    T = lambda x: _t(x, torch.float64)  # noqa: E731
    J64 = dict(dtype=jnp.float64)
    gaps = {}
    if chain == "pipeline":
        f, _ = jdt.dist_tlr_pipeline_lowerable(
            N, P, jp, gen="xla", mesh=jmesh, block_cyclic=True, **J64, **TLR_KW)
        g, _ = tdt.dist_tlr_pipeline_lowerable(
            N, P, tp, mesh=mesh, block_cyclic=True, **F64, **TLR_KW)
        a, b = jax.jit(f)(locs, z), g(T(locs), T(z))
        gaps["loglik"] = _rel(a.loglik, b.loglik)
        assert bool(b.status.ok)
    elif chain == "gen":
        f, _ = jdt.dist_tlr_gen_lowerable(
            N, P, jp, tile_size=NB, gen="xla", mesh=jmesh, **J64)
        g, _ = tdt.dist_tlr_gen_lowerable(N, P, tp, tile_size=NB, mesh=mesh, **F64)
        gaps["checksum"] = _rel(jax.jit(f)(locs), g(T(locs)))
    elif chain == "compress_factorize":
        f, _ = jdt.dist_tlr_compress_lowerable(
            N, P, jp, gen="xla", mesh=jmesh, block_cyclic=True, **J64, **TLR_KW)
        g, _ = tdt.dist_tlr_compress_lowerable(
            N, P, tp, mesh=mesh, block_cyclic=True, **F64, **TLR_KW)
        jt, tt = jax.jit(f)(locs), g(T(locs))
        np.testing.assert_array_equal(np.asarray(jt[3]), tt[3].numpy())
        gaps["diag"] = _rel(jt[0], tt[0])
        gaps["tiles"] = _rel(_tiles(jt[1], jt[2]), _tiles(tt[1], tt[2]))
        f, _ = jdt.dist_tlr_lowerable(
            M // NB, NB, KMAX, tol=1e-7, mesh=jmesh, block_cyclic=True,
            return_factor=True, **J64)
        g, _ = tdt.dist_tlr_lowerable(
            M // NB, NB, KMAX, tol=1e-7, mesh=mesh, block_cyclic=True,
            return_factor=True, **F64)
        ja, jf = jax.jit(f)(*jt, z)
        args = [x.clone() for x in tt] + [T(z)]
        ta, tf = g(*args)
        assert all(a is b for a, b in zip(tf, args[:4]))  # written in place
        np.testing.assert_array_equal(np.asarray(jf[3]), tf[3].numpy())
        gaps["factor_loglik"] = _rel(ja.loglik, ta.loglik)
        gaps["diag_l"] = _rel(jf[0], tf[0])
        gaps["factor_tiles"] = _rel(_tiles(jf[1], jf[2]), _tiles(tf[1], tf[2]))
    elif chain == "loglik":
        f, _ = jdc.dist_loglik_lowerable(N, P, jp, panel=PANEL, mesh=jmesh, **J64)
        g, _ = tdc.dist_loglik_lowerable(N, P, tp, panel=PANEL, mesh=mesh, **F64)
        gaps["loglik"] = _rel(jax.jit(f)(locs, z).loglik, g(T(locs), T(z)).loglik)
    elif chain == "cokrige":
        f, _ = jdc.dist_cokrige_lowerable(N, 64, P, jp, panel=PANEL, mesh=jmesh, **J64)
        g, _ = tdc.dist_cokrige_lowerable(N, 64, P, tp, panel=PANEL, mesh=mesh, **F64)
        gaps["preds"] = _rel(
            jax.jit(f)(locs, pred[:64], z), g(T(locs), T(pred[:64]), T(z)))
    elif chain == "cholesky":
        f, _ = jdc.dist_cholesky_lowerable(M, panel=PANEL, mesh=jmesh, **J64)
        g, _ = tdc.dist_cholesky_lowerable(M, panel=PANEL, mesh=mesh, **F64)
        sigma = np.asarray(j_build_sigma(locs, jp, nugget=1e-6))
        buf = T(sigma).clone()
        got = g(buf)
        assert got.data_ptr() == buf.data_ptr()  # the factor in Sigma's storage
        gaps["factor"] = _rel(jax.jit(f)(sigma), got)
    elif chain == "serving":
        f, _ = jcs.cokrige_fit_lowerable(N, P, jp, gen="xla", mesh=jmesh, **J64, **TLR_KW)
        g, _ = tcs.cokrige_fit_lowerable(N, P, tp, mesh=mesh, **F64, **TLR_KW)
        jo, to = jax.jit(f)(locs, z), g(T(locs), T(z))
        np.testing.assert_array_equal(np.asarray(jo[3]), to[3].numpy())
        gaps["fit_diag_l"] = _rel(jo[0], to[0])
        gaps["fit_tiles"] = _rel(_tiles(jo[1], jo[2]), _tiles(to[1], to[2]))
        gaps["fit_alpha"] = _rel(jo[4], to[4])
        kw = dict(tile_size=NB, max_rank=KMAX, batch=64)
        f, _ = jcs.cokrige_predict_lowerable(N, P, jp, gen="xla", mesh=jmesh, **J64, **kw)
        g, _ = tcs.cokrige_predict_lowerable(N, P, tp, mesh=mesh, **F64, **kw)
        for key, a, b in zip(("mean", "variance", "lower", "upper"),
                             jax.jit(f)(*jo, locs, pred[:64]),
                             g(*to, T(locs), T(pred[:64]))):
            gaps[key] = _rel(a, b)
    return gaps


CHAINS = ("pipeline", "gen", "compress_factorize", "loglik", "cokrige", "cholesky",
          "serving")


@pytest.mark.parametrize("chain", CHAINS)
def test_cells_match_the_reference_in_float64(meshes, data, chain):
    """Each constructor pair in float64: every output within 1e-9 of the
    reference's, the truncation ranks equal."""
    gaps = _run_f64(chain, *meshes, data)
    assert gaps and max(gaps.values()) <= F64_TOL, gaps


# ---------------------------------------------------------------------------
# float32: through both registries
# ---------------------------------------------------------------------------


def _registry_f32(cell, mesh, jmesh, data):
    locs, z, pred = data
    T = lambda x: _t(x, torch.float32)  # noqa: E731
    l32, z32 = locs.astype(np.float32), z.astype(np.float32)
    p32 = pred.astype(np.float32)
    j = jl.build(cell, SHAPE, jmesh)[cell]
    t = tl.build(cell, SHAPE, mesh)[cell]
    gaps = {}
    if cell == "dist_loglik_lowerable":
        gaps["loglik"] = _rel(jax.jit(j.fn)(l32, z32).loglik, t.fn(T(l32), T(z32)).loglik)
    elif cell == "dist_tlr_gen_lowerable":
        gaps["checksum"] = _rel(jax.jit(j.fn)(l32), t.fn(T(l32)))
    elif cell == "dist_tlr_compress_lowerable":
        jt, tt = jax.jit(j.fn)(l32), t.fn(T(l32))
        gaps["diag"] = _rel(jt[0], tt[0])
        gaps["tiles"] = _rel(_tiles(jt[1], jt[2]), _tiles(tt[1], tt[2]))
    elif cell == "dist_cokrige_lowerable":
        npred = j.specs[1].shape[0]
        gaps["preds"] = _rel(jax.jit(j.fn)(l32, p32[:npred], z32),
                             t.fn(T(l32), T(p32[:npred]), T(z32)))
    return gaps


# The reference's side of the float32 TLR chains, run in a subprocess
# pinned to two cores, which XLA sizes its thread pools by: in-process, this
# worker's XLA thread pools (one thread a core) contend with the suite's
# other workers, and these cells took 355-392 s each there (6-7 s alone).
# Pinned to two cores, the three chains take about 27 s.  argv: the
# inputs' .npz, the outputs' .npz.
_REF_F32_TLR = r"""
import os
import sys

os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])
import jax
import numpy as np

jax.config.update("jax_enable_x64", True)  # as tests/conftest.py
import repro.lowerables as jl
from repro.configs.base import GeoStatShape

d = np.load(sys.argv[1])
shape = GeoStatShape("t512", int(d["n"]), int(d["p"]), "mle")
mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
l32, z32, p32 = d["locs"], d["z"], d["pred"]


def cell(name, key):
    return jax.jit(jl.build(name, shape, mesh)[key].fn)


out = {}
out["pipeline/loglik"] = cell("dist_tlr_pipeline_lowerable",
                              "dist_tlr_pipeline_lowerable")(l32, z32).loglik
res, factor = cell("dist_tlr_lowerable", "dist_tlr_lowerable")(
    *cell("dist_tlr_compress_lowerable", "dist_tlr_compress_lowerable")(l32), z32)
out["compress_factorize/loglik"], out["compress_factorize/diag_l"] = res.loglik, factor[0]
fit = cell("cokrige_serving", "serve_fit")(l32, z32)
out["serving/fit_alpha"] = fit[4]
npred = jl.build("cokrige_serving", shape, mesh)["serve_predict"].specs[-1].shape[0]
pred = cell("cokrige_serving", "serve_predict")(*fit, l32, p32[:npred])
out["serving/mean"], out["serving/variance"] = pred[0], pred[1]
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def ref_f32_tlr(data, tmp_path_factory):
    """The reference's float32 TLR chains' outputs, by "chain/output"."""
    locs, z, pred = data
    d = tmp_path_factory.mktemp("ref_f32_tlr")
    np.savez(d / "in.npz", n=N, p=P, locs=locs.astype(np.float32),
             z=z.astype(np.float32), pred=pred.astype(np.float32))
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH", "")]),
    )
    subprocess.run([sys.executable, "-c", _REF_F32_TLR, str(d / "in.npz"),
                    str(d / "out.npz")], env=env, check=True, timeout=600)
    return dict(np.load(d / "out.npz"))


def _port_f32_tlr(chain, mesh, data) -> dict:
    """The port's side of a float32 TLR chain through its registry: the
    pipeline; compress into factorize; serve_fit into serve_predict."""
    locs, z, pred = data
    T = lambda x: _t(x, torch.float32)  # noqa: E731
    l32, z32, p32 = T(locs), T(z), T(pred)

    def cell(name, key):
        return tl.build(name, SHAPE, mesh)[key]

    if chain == "pipeline":
        return {"loglik": cell("dist_tlr_pipeline_lowerable",
                               "dist_tlr_pipeline_lowerable").fn(l32, z32).loglik}
    if chain == "compress_factorize":
        tiles = cell("dist_tlr_compress_lowerable", "dist_tlr_compress_lowerable").fn(l32)
        res, factor = cell("dist_tlr_lowerable", "dist_tlr_lowerable").fn(*tiles, z32)
        return {"loglik": res.loglik, "diag_l": factor[0]}
    fit = cell("cokrige_serving", "serve_fit").fn(l32, z32)
    predict = cell("cokrige_serving", "serve_predict")
    npred = predict.specs[-1].shape[0]
    mean, var = predict.fn(*fit, l32, p32[:npred])[:2]
    return {"fit_alpha": fit[4], "mean": mean, "variance": var}


@pytest.mark.parametrize("cell", list(F32_TOL))
def test_registry_cells_match_the_reference_in_float32(meshes, data, cell):
    """A registered cell through both registries in float32 (the
    ``fma_f32`` instances' dtype on the card), at its stated tolerance."""
    gaps = _registry_f32(cell, *meshes, data)
    assert gaps and max(gaps.values()) <= F32_TOL[cell], gaps


@pytest.mark.parametrize("chain", list(F32_TLR_TOL))
def test_registry_tlr_cells_match_the_reference_in_float32(
    meshes, data, ref_f32_tlr, chain
):
    """The cells that run the whole TLR factorization through both
    registries in float32, chained (compress into factorize, fit into
    predict), at their stated tolerances."""
    got = _port_f32_tlr(chain, meshes[0], data)
    gaps = {k: _rel(ref_f32_tlr[f"{chain}/{k}"], v) for k, v in got.items()}
    assert gaps and max(gaps.values()) <= F32_TLR_TOL[chain], gaps
