"""The port's Matérn functions (repro_torch.core.matern) against the JAX
reference (repro.core.matern) and scipy, on the CPU in float64."""

import math
import re
from decimal import Decimal, localcontext
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.special as sps  # noqa: E402

from repro.core import matern as jm  # noqa: E402
from repro_torch.core import matern as tm  # noqa: E402
from repro_torch.kernels import matern_tile as mt  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

XS = np.concatenate(
    [
        np.geomspace(1e-8, 1.9, 30),
        np.array([1.999, 2.0, 2.001]),
        np.geomspace(2.1, 60.0, 30),
    ]
)
US = np.concatenate([[0.0], np.geomspace(1e-6, 30.0, 80)])


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


@pytest.mark.parametrize("nu", [0.05, 0.3, 0.5, 0.73, 1.0, 1.5, 2.283, 3.7, 4.5, 6.0])
def test_kv_matches_jax_and_scipy(nu):
    got = tm.kv(nu, _t(XS)).numpy()
    want = np.asarray(jm.kv(nu, jnp.asarray(XS)))
    np.testing.assert_allclose(got, want, rtol=1e-11)
    np.testing.assert_allclose(got, sps.kv(nu, XS), rtol=5e-9)


def test_kv_half_integer_closed_forms():
    for nu in (0.5, 1.5, 2.5):
        got = tm.kv_half_integer(nu, _t(XS)).numpy()
        want = np.asarray(jm.kv_half_integer(nu, jnp.asarray(XS)))
        np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_matern_correlation_halfint_matches_jax(nu):
    got = tm.matern_correlation_halfint(_t(US), nu).numpy()
    want = np.asarray(jm.matern_correlation_halfint(jnp.asarray(US), nu))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("nu", [0.5, 0.75, 1.0, 2.033, 2.5])
def test_matern_correlation_matches_jax(nu):
    got = tm.matern_correlation(_t(US), nu).numpy()
    want = np.asarray(jm.matern_correlation(jnp.asarray(US), nu))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_parsimonious_rho_and_nu_matrix_match_jax():
    nus = np.array([0.5, 1.2, 2.3])
    beta = np.array([[1.0, 0.4, -0.2], [0.4, 1.0, 0.3], [-0.2, 0.3, 1.0]])
    for d in (1, 2, 3):
        got = tm.parsimonious_rho(_t(nus), _t(beta), d=d).numpy()
        want = jm.parsimonious_rho(jnp.asarray(nus), jnp.asarray(beta), d=d)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12)
    got = tm.parsimonious_nu_matrix(_t(nus)).numpy()
    want = np.asarray(jm.parsimonious_nu_matrix(nus))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_cross_covariance_matches_jax():
    h = np.geomspace(1e-4, 1.5, 40).reshape(8, 5)
    sig2 = np.array([1.0, 2.0])
    nus = np.array([0.5, 1.0])
    beta = np.array([[1.0, 0.6], [0.6, 1.0]])
    got = tm.cross_covariance(_t(h), _t(sig2), 0.2, _t(nus), _t(beta)).numpy()
    args = (jnp.asarray(x) for x in (h, sig2, 0.2, nus, beta))
    want = np.asarray(jm.cross_covariance(*args))
    assert got.shape == want.shape == (8, 5, 2, 2)
    np.testing.assert_allclose(got, want, rtol=1e-12)


# The general instance of the Matérn kernels (csrc/matern.cuh): its loops
# emulated one element at a time, and the edge values of its input.
NUS_GENERAL = [0.05, 0.73, 1.0, 2.283, 3.7, 6.0]
EDGE_US = np.array(
    [
        0.0,
        1e-8,
        np.nextafter(2.0, 0.0),
        2.0,
        np.nextafter(2.0, 4.0),
        47.0,
        800.0,
    ]
)


def _emulate_general(u, nu):
    """csrc/matern.cuh's general instance on one element, in Python floats
    (float64): the host array of ``general_args`` (scalars and reciprocal
    tables), Temme's series for u <= 2 or Steed's CF2 above, each stopping
    at this element's own convergence, the nl upward recurrences and the
    normalisation.  Returns (K_nu(u), M_nu(u), steps of the loop)."""
    args = mt.general_args(nu)
    s = mt.GeneralScalars(*args[: mt.N_SCALARS])
    tab = args[mt.N_SCALARS :].reshape(mt.N_TABLES, mt.TABLE_LEN)
    eps = np.finfo(np.float64).eps
    mu = s.mu
    if u <= 0.0:
        return math.inf, 1.0, 0
    xs = max(u, 1e-30)
    steps = 0
    if xs <= 2.0:
        x2 = 0.5 * xs
        d = -math.log(x2)
        e = mu * d
        fact2 = 1.0 if abs(e) < 1e-12 else math.sinh(e) / e
        ff = s.fact * (s.gam1 * math.cosh(e) + s.gam2 * fact2 * d)
        ee = math.exp(e)
        p = 0.5 * ee / s.gampl
        q = 0.5 / (ee * s.gammi)
        c, d2 = 1.0, x2 * x2
        ksum, ksum1 = ff, p
        for i in range(1, mt.TEMME_MAX + 1):
            fi = float(i)
            ff = (fi * ff + p + q) * tab[1, i]
            c = c * d2 * tab[0, i]
            p = p * tab[2, i]
            q = q * tab[3, i]
            delk = c * ff
            delk1 = c * (p - fi * ff)
            ksum += delk
            ksum1 += delk1
            steps += 1
            if abs(delk) < abs(ksum) * eps:
                break
        rkmu, rk1 = ksum, ksum1 * 2.0 / xs
    else:
        a1 = 0.25 - mu * mu
        a, b = -a1, 2.0 * (1.0 + xs)
        d = 1.0 / b
        h = delh = d
        q1, q2, q, c = 0.0, 1.0, a1, a1
        sv = 1.0 + q * delh
        for i in range(2, mt.CF2_MAX + 2):
            fi = float(i)
            a = a - 2.0 * (fi - 1.0)
            c = -a * c * tab[0, i]
            qnew = (q1 - b * q2) * tab[4, i]
            q1, q2 = q2, qnew
            q = q + c * qnew
            b = b + 2.0
            d = 1.0 / (b + a * d)
            delh = (b * d - 1.0) * delh
            h = h + delh
            dels = q * delh
            sv = sv + dels
            steps += 1
            if abs(dels) < eps * abs(sv):
                break
        h = a1 * h
        rkmu = math.sqrt(math.pi / (2.0 * xs)) * math.exp(-xs) / sv
        rk1 = rkmu * (mu + xs + 0.5 - h) / xs
    two_x = 2.0 / xs
    for i in range(1, int(s.nl) + 1):
        rkmu, rk1 = rk1, (mu + i) * two_x * rk1 + rkmu
    return rkmu, math.exp(s.nu * math.log(u) - s.lognorm) * rkmu, steps


@pytest.mark.parametrize("nu", NUS_GENERAL)
def test_general_instance_emulation_matches_vectorised_kv(nu):
    """The kernel's per-element loop (reciprocal tables, its own stop) gives
    K_nu and M_nu of the vectorised plain version, whose accumulators freeze
    at convergence, over XS and the edge values; general_steps counts the
    emulation's steps."""
    emulated = [_emulate_general(x, nu) for x in XS]
    k = np.array([e[0] for e in emulated])
    np.testing.assert_allclose(k, tm.kv(nu, _t(XS)).numpy(), rtol=1e-11)
    m = np.array([_emulate_general(u, nu)[1] for u in EDGE_US])
    np.testing.assert_allclose(m, tm.matern_correlation(_t(EDGE_US), nu), rtol=1e-11)
    steps, temme = mt.general_steps(_t(XS), nu, chunk=16)
    np.testing.assert_array_equal(steps.numpy(), [e[2] for e in emulated])
    np.testing.assert_array_equal(temme.numpy(), XS <= 2.0)
    steps, _ = mt.general_steps(_t(EDGE_US), nu)
    assert steps[0] == 0 and max(e[2] for e in emulated) < mt.TABLE_LEN


@pytest.mark.parametrize("nu", NUS_GENERAL + [0.5, 1.5, 2.5])
def test_matern_corr_ref_matches_jax_at_edge_values(nu):
    """The plain version of the matern_corr kernel at u = 0, 1e-8, 2 and its
    neighbours (the branch xs <= 2), 47 (the main cell's largest) and 800
    (exp(-u) underflows: M is 0, not NaN), against the reference."""
    got = ref.matern_corr_ref(_t(EDGE_US), 1.7, nu).numpy()
    want = 1.7 * np.asarray(jm.matern_correlation(jnp.asarray(EDGE_US), nu))
    assert np.isfinite(got).all()
    assert got[0] == 1.7 and got[-1] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=0.0)


@pytest.mark.parametrize("nu", NUS_GENERAL + [0.5, 1.5, 2.5, 0.999999, 1.0000004])
def test_general_scalars_match_chepolish_and_lgamma(nu):
    """The host scalars of a general launch against core.matern's
    _chepolish (torch.lgamma) and kv's reduction nu = nl + mu."""
    s = mt.general_scalars(nu)
    assert s.nl == math.floor(nu + 0.5) and s.mu == nu - s.nl
    assert abs(s.mu) <= 0.5
    want = [t.item() for t in tm._chepolish(torch.tensor(s.mu, dtype=torch.float64))]
    np.testing.assert_allclose([s.gam2, s.gampl, s.gammi], want[1:], rtol=1e-14)
    # gam1 = (gammi - gampl) / (2 mu) cancels as mu -> 0 (the plain version
    # too): an ulp of gammi or gampl moves it by about eps / |mu|
    cancel = 0.0 if abs(s.mu) < 1e-6 else 4 * np.finfo(float).eps / abs(2 * s.mu)
    np.testing.assert_allclose(s.gam1, want[0], rtol=1e-14, atol=cancel)
    nu_t = torch.tensor(nu, dtype=torch.float64)
    lognorm = ((nu_t - 1.0) * math.log(2.0) + torch.lgamma(nu_t)).item()
    np.testing.assert_allclose(s.lognorm, lognorm, rtol=1e-14, atol=1e-15)
    pimu = math.pi * s.mu
    assert s.fact == (1.0 if abs(pimu) < 1e-12 else pimu / math.sin(pimu))
    args = mt.general_args(nu)
    assert args.shape == (mt.N_SCALARS + mt.N_TABLES * mt.TABLE_LEN,)
    assert tuple(args[: mt.N_SCALARS]) == tuple(float(v) for v in s)
    tab = args[mt.N_SCALARS :].reshape(mt.N_TABLES, mt.TABLE_LEN)
    i = np.arange(1, mt.TABLE_LEN, dtype=np.float64)
    np.testing.assert_array_equal(tab[:, 0], 0.0)
    np.testing.assert_array_equal(tab[0, 1:], 1.0 / i)
    np.testing.assert_array_equal(tab[1, 1:], 1.0 / (i * i - s.mu * s.mu))
    np.testing.assert_allclose(1.0 / tab[4, 2:], -(0.25 - s.mu**2) - i[1:] * i[:-1])


def _exp_neg_constants():
    """csrc/matern.cuh's exp_neg constants and 2^(j/64) table, read from
    the source."""
    text = (
        Path(__file__).resolve().parents[1]
        / "src/repro_torch/kernels/csrc/matern.cuh"
    ).read_text()
    found = re.findall(r"constexpr double (k\w+) = ([0-9a-fx.p+-]+);", text)
    consts = {name: float.fromhex(value) for name, value in found}
    body = text.split("kExp2By64[64] = {", 1)[1].split("};", 1)[0]
    table = [float.fromhex(v) for v in re.findall(r"0x[0-9a-f.]+p[+-]\d+", body)]
    return consts, table


def _fma(a, b, c):
    """a * b + c rounded once (an FMA), through decimals exact at the
    caller's precision."""
    return float(Decimal(a) * Decimal(b) + Decimal(c))


def test_exp_neg_emulation_is_within_two_ulp_of_exp():
    """The closed forms' exp(-u) (csrc/matern.cuh::exp_neg), emulated with
    its own constants, FMAs rounded once: the table is 2^(j/64) correctly
    rounded, and exp_neg is within 2 ulp of the exact exp(-u) over
    [0, 708]; above 708 it gives 0."""
    c, table = _exp_neg_constants()
    assert len(table) == 64
    with localcontext(prec=200):
        for j, v in enumerate(table):
            assert v == float(Decimal(2) ** (Decimal(j) / 64))
        _check_exp_neg(c, table)


def _check_exp_neg(c, table):

    def exp_neg(u):
        if u > 708.0:
            return 0.0
        t = _fma(-u, c["kLog2eBy64"], c["kRoundShift"])
        nd = t - c["kRoundShift"]
        n = int(nd)
        r = _fma(nd, -c["kLn2By64Hi"], -u)
        r = _fma(nd, -c["kLn2By64Lo"], r)
        p = _fma(r, 1.0 / 120, 1.0 / 24)
        for coef in (1.0 / 6, 0.5, 1.0, 1.0):
            p = _fma(p, r, coef)
        return table[n & 63] * p * 2.0 ** (n >> 6)

    rng = np.random.default_rng(11)
    us = np.concatenate(
        [[0.0, 1e-300, 1e-8, 0.5, 2.0, 47.0, 700.0, 708.0], rng.uniform(0, 60, 400)]
    )
    us = np.concatenate([us, rng.uniform(0, 708, 200)])
    for u in us:
        want = Decimal(-float(u)).exp()
        err = abs(Decimal(exp_neg(float(u))) - want)
        assert float(err) <= 2 * math.ulp(float(want)), u
    assert exp_neg(708.5) == 0.0 and exp_neg(800.0) == 0.0
