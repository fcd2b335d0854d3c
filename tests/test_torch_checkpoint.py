"""The port's checkpointing (repro_torch.checkpointing) and checkpointed
multistart estimation against the JAX reference, on the CPU: the
reference's checkpoint tests on the port, the same leaf names and layout
(a checkpoint written by either package restores in the other), a
mid-start Nelder–Mead state carried across packages, the async saver's
snapshot and error, the bfloat16 refusal (and the reference's fault it
makes explicit), and a TLR fit interrupted mid-run and resumed."""

import json
import os
import shutil
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The suite runs in several pytest workers on one CPU: one torch thread a
# worker keeps them from contending (the tensors here are small).
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.checkpointing import checkpoint as jck  # noqa: E402
from repro.core import mle as jm  # noqa: E402
from repro.core import optimize as jo  # noqa: E402
from repro_torch.checkpointing import checkpoint as tck  # noqa: E402
from repro_torch.core import covariance as tc  # noqa: E402
from repro_torch.core import mle as tm  # noqa: E402
from repro_torch.core import optimize as to  # noqa: E402
from repro_torch.core.simulate import uniform_locations  # noqa: E402


def _vec(values):
    return torch.tensor(values, dtype=torch.float64)


def _quad(xp):
    return lambda x: xp.sum((x - 2.0) ** 2)


# ---------------------------------------------------------------------------
# tests/test_recovery.py's checkpoint tests, on the port
# ---------------------------------------------------------------------------


def test_checkpoint_manager_roundtrip_and_gc(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path / "cm"), keep=2)
    tree = {"a": torch.arange(4.0, dtype=torch.float64), "b": torch.ones((2, 3))}
    for s in range(4):
        mgr.save(s, tree, extra={"s": s})
    assert mgr.latest_step() == 3
    assert mgr.all_steps() == [2, 3]  # keep=2 garbage-collected 0, 1
    restored, manifest = mgr.restore(tree)
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(4.0))
    assert restored["b"].dtype == torch.float32
    assert manifest["extra"]["s"] == 3
    assert not [d for d in os.listdir(mgr.directory) if d.startswith(".tmp_ckpt_")]


def test_checkpoint_gc_tolerates_racing_deletion(tmp_path):
    d = str(tmp_path / "gc")
    mgr = tck.CheckpointManager(d, keep=1)
    for s in range(3):
        mgr.save(s, {"x": torch.zeros(2)})
    tck._gc_old(str(tmp_path / "missing"), keep=1)  # directory never existed
    shutil.rmtree(d)
    tck._gc_old(d, keep=1)  # vanished mid-flight
    assert tck.CheckpointManager(d).all_steps() == []


def test_multistart_checkpoint_resume(tmp_path):
    fn = _quad(torch)
    x0s = [_vec([0.0, 0.0]), _vec([5.0, 5.0])]
    ref = to.multistart_nelder_mead(fn, x0s, max_iters=60)
    want = jo.multistart_nelder_mead(
        _quad(jnp), [jnp.asarray([0.0, 0.0]), jnp.asarray([5.0, 5.0])], max_iters=60
    )
    assert float(ref.value) == pytest.approx(float(want.value), abs=1e-12)

    d = str(tmp_path / "ck")
    r1 = to.multistart_nelder_mead(
        fn, x0s, max_iters=60, checkpoint_dir=d, checkpoint_every=10
    )
    assert float(r1.value) == pytest.approx(float(ref.value), abs=1e-10)

    # Re-running against the finished checkpoint replays recorded results.
    r2 = to.multistart_nelder_mead(
        fn, x0s, max_iters=60, checkpoint_dir=d, checkpoint_every=10
    )
    assert float(r2.value) == pytest.approx(float(ref.value), abs=1e-10)
    np.testing.assert_allclose(r2.x.numpy(), r1.x.numpy())


def test_multistart_resumes_mid_start_state(tmp_path):
    """Crash simulation: a checkpoint written mid-way through start 0 is
    picked up and continued to the same optimum as an uninterrupted run."""
    fn = _quad(torch)
    x0s = [_vec([0.0, 0.0]), _vec([5.0, 5.0])]
    ref = to.multistart_nelder_mead(fn, x0s, max_iters=60)

    partial = to.nelder_mead(fn, x0s[0], max_iters=8)
    d = str(tmp_path / "crash")
    mgr = tck.CheckpointManager(d)
    mgr.save(
        0,
        {"state": partial.state},
        extra={
            "start_index": 0,
            "iters_done": int(partial.state.n_iters),
            "done_values": [],
        },
    )
    res = to.multistart_nelder_mead(
        fn, x0s, max_iters=60, checkpoint_dir=d, checkpoint_every=30
    )
    assert float(res.value) == pytest.approx(float(ref.value), abs=1e-10)


# ---------------------------------------------------------------------------
# The same layout and leaf names in both packages
# ---------------------------------------------------------------------------


class _Pair(NamedTuple):
    first: object
    second: object = None


def _trees(xp, tensor):
    """One tree of each kind the flattener takes, in numpy (for the
    reference) or torch: a dict with its keys out of order, a NamedTuple,
    a list holding None, a Python int."""
    return {
        "zeta": 7,
        "alpha": [tensor(np.arange(3.0)), None, tensor(np.ones((2, 2), np.float32))],
        "mid": _Pair(tensor(np.arange(4, dtype=np.int32)), {"y": 2.5, "x": (1, 2)}),
    }


def test_manifest_names_and_layout_equal_the_reference(tmp_path):
    port_tree = _trees(torch, torch.as_tensor)
    ref_tree = _trees(jnp, jnp.asarray)
    tck.save_checkpoint(str(tmp_path / "port"), 5, port_tree, extra={"k": 1})
    jck.save_checkpoint(str(tmp_path / "ref"), 5, ref_tree, extra={"k": 1})
    manifests = []
    for name in ("port", "ref"):
        root = tmp_path / name
        assert (root / "LATEST").read_text() == "step_00000005"
        assert sorted(os.listdir(root / "step_00000005")) == [
            "arrays.npz",
            "manifest.json",
        ]
        manifests.append(json.loads((root / "step_00000005/manifest.json").read_text()))
    got, want = manifests
    assert got["names"] == want["names"] == tck._flatten_with_names(port_tree)[0]
    assert got["names"][0] == "['alpha'][0]" and got["names"][-1] == "['zeta']"
    for key in ("step", "dtypes", "shapes", "extra"):
        assert got[key] == want[key]

    # each package restores the other's checkpoint
    back, _ = tck.restore_checkpoint(str(tmp_path / "ref"), port_tree)
    assert back["alpha"][1] is None and isinstance(back["mid"], _Pair)
    assert back["zeta"].dtype == torch.int64 and int(back["zeta"]) == 7
    np.testing.assert_array_equal(back["alpha"][2].numpy(), np.ones((2, 2)))
    assert back["alpha"][2].dtype == torch.float32
    jback, _ = jck.restore_checkpoint(str(tmp_path / "port"), ref_tree)
    np.testing.assert_array_equal(np.asarray(jback["mid"].first), np.arange(4))
    assert float(jback["mid"].second["y"]) == 2.5

    with pytest.raises(ValueError, match="structure mismatch"):
        tck.restore_checkpoint(str(tmp_path / "ref"), {"other": torch.zeros(1)})


def test_restore_places_leaves_on_the_asked_device(tmp_path):
    d = str(tmp_path / "dev")
    w = torch.ones(3, requires_grad=True)
    tck.save_checkpoint(d, 0, {"w": w * 2})  # a leaf that requires grad
    back, _ = tck.restore_checkpoint(d, {"w": w}, device="cpu")
    assert not back["w"].requires_grad and back["w"].device.type == "cpu"
    np.testing.assert_array_equal(back["w"].numpy(), [2.0, 2.0, 2.0])
    back, _ = tck.restore_checkpoint(d, {"w": 0.0})  # no tensor: the CPU
    assert back["w"].device.type == "cpu"


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_mid_start_nm_state_resumes_across_packages(tmp_path, writer):
    """A state written mid-start by one package's CheckpointManager resumes
    in the other package's multistart to the reference's uninterrupted
    value."""
    jx0s = [jnp.asarray([0.0, 0.0]), jnp.asarray([5.0, 5.0])]
    want = jo.multistart_nelder_mead(_quad(jnp), jx0s, max_iters=60)
    d = str(tmp_path / writer)
    if writer == "reference":
        part = jo.nelder_mead(_quad(jnp), jx0s[0], max_iters=8)
        mgr = jck.CheckpointManager(d)
    else:
        part = to.nelder_mead(_quad(torch), _vec([0.0, 0.0]), max_iters=8)
        mgr = tck.CheckpointManager(d)
    mgr.save(
        0,
        {"state": part.state},
        extra={"start_index": 0, "iters_done": 8, "done_values": []},
    )
    if writer == "reference":
        x0s = [_vec([0.0, 0.0]), _vec([5.0, 5.0])]
        got = to.multistart_nelder_mead(
            _quad(torch), x0s, max_iters=60, checkpoint_dir=d, checkpoint_every=30
        )
    else:
        got = jo.multistart_nelder_mead(
            _quad(jnp), jx0s, max_iters=60, checkpoint_dir=d, checkpoint_every=30
        )
    assert float(got.value) == pytest.approx(float(want.value), abs=1e-10)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(want.x), atol=1e-10)


# ---------------------------------------------------------------------------
# The async saver, and the bfloat16 refusal
# ---------------------------------------------------------------------------


def test_async_checkpointer_snapshots_at_save_and_raises_at_wait(tmp_path):
    d = str(tmp_path / "async")
    ck = tck.AsyncCheckpointer(d, keep=2)
    x = torch.zeros(1000, dtype=torch.float64)
    ck.save(0, {"x": x, "n": 3})
    x += 1.0  # in place, before the worker is joined
    ck.wait()
    back, _ = tck.restore_checkpoint(d, {"x": x, "n": 3})
    assert float(back["x"].abs().max()) == 0.0 and int(back["n"]) == 3

    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    bad = tck.AsyncCheckpointer(str(blocker / "ck"))
    bad.save(0, {"x": x})
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()  # the error is raised once


def test_bfloat16_leaf_is_refused_at_save(tmp_path):
    d = str(tmp_path / "bf16")
    with pytest.raises(ValueError, match="bfloat16.*Queue 3"):
        tck.save_checkpoint(d, 0, {"w": torch.ones((2, 3), dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        tck.AsyncCheckpointer(d).save(0, [torch.zeros(1, dtype=torch.bfloat16)])
    assert tck.latest_step(d) is None


def test_reference_bf16_checkpoint_fault_is_recorded(tmp_path):
    """ROADMAP Queue 3: the reference writes a bf16 leaf (manifest
    'bfloat16', npz '|V2') that its own restore cannot read; the port
    refuses it at save and at restore instead."""
    d = str(tmp_path / "ref_bf16")
    tree = {"w": jnp.ones((2, 3), jnp.bfloat16)}
    jck.save_checkpoint(d, 0, tree)
    manifest = json.loads(open(os.path.join(d, "step_00000000/manifest.json")).read())
    assert manifest["dtypes"] == ["bfloat16"]
    assert np.load(os.path.join(d, "step_00000000/arrays.npz"))["a0"].dtype == "|V2"
    with pytest.raises(TypeError, match="V2"):
        jck.restore_checkpoint(d, tree)
    with pytest.raises(ValueError, match="bfloat16"):
        tck.restore_checkpoint(d, {"w": torch.zeros((2, 3))})


# ---------------------------------------------------------------------------
# A checkpointed TLR fit, interrupted and resumed
# ---------------------------------------------------------------------------

# test_torch_mle.py's TLR-tiles objective (n = 40, max rank 16, all six
# parameters free; the reference's objective there agrees at 1e-9) at tile
# 40 (two tiles): the reference's fit compiles its objective into every
# branch of its loop, 32 s at tile 20 against 15 s here.
FIT = dict(
    p=2,
    backend="tlr",
    tile_size=40,
    tlr_max_rank=16,
    tlr_from_tiles=True,
    profile=False,
    max_iters=6,
)


class _Crash(RuntimeError):
    pass


def _counting(monkeypatch, limit=None):
    """Wrap the objective ``fit`` builds: count its evaluations and, past
    ``limit``, raise (a crash mid-fit)."""
    real = tm.make_objective
    calls = []

    def make(*args, **kwargs):
        fn, dists = real(*args, **kwargs)

        def counted(x):
            if limit is not None and len(calls) >= limit:
                raise _Crash("injected crash")
            calls.append(1)
            return fn(x)

        return counted, dists

    monkeypatch.setattr(tm, "make_objective", make)
    return calls


def test_checkpointed_fit_resumes_to_the_uninterrupted_fit(tmp_path, monkeypatch):
    locs = uniform_locations(40, seed=3)
    locs = locs[tc.morton_order(locs)]
    z = np.random.default_rng(5).normal(size=2 * len(locs))
    cfg = tm.MLEConfig(**FIT, gen="plain")
    with monkeypatch.context() as mp:
        full_calls = _counting(mp)
        full = tm.fit(locs, z, cfg, device="cpu")
    assert full.n_iters == FIT["max_iters"]

    d = str(tmp_path / "fit")
    with monkeypatch.context() as mp:
        done = _counting(mp, limit=12)
        with pytest.raises(_Crash):
            tm.fit(locs, z, cfg, checkpoint_dir=d, checkpoint_every=1, device="cpu")
    assert len(done) == 12
    saved = tck.latest_step(d)
    assert saved is not None and 0 <= saved < FIT["max_iters"] - 1
    with monkeypatch.context() as mp:
        resumed_calls = _counting(mp)
        got = tm.fit(locs, z, cfg, checkpoint_dir=d, checkpoint_every=1, device="cpu")
    # the resume evaluates only what the saved state had not (step s holds
    # the state after s + 1 iterations): no evaluation is spent to learn
    # the aux tree's structure
    with monkeypatch.context() as mp:
        saved_calls = _counting(mp)
        cut = tm.MLEConfig(**{**FIT, "max_iters": saved + 1}, gen="plain")
        tm.fit(locs, z, cut, device="cpu")
    assert len(resumed_calls) == len(full_calls) - len(saved_calls)
    assert len(resumed_calls) < full.n_evals
    assert (got.n_iters, got.n_evals) == (full.n_iters, full.n_evals)
    assert float(got.loglik) == pytest.approx(float(full.loglik), rel=1e-12)
    x, x_full = (tm.pack_params(r.params, False).numpy() for r in (got, full))
    np.testing.assert_allclose(x, x_full, rtol=0, atol=1e-12)
    assert int(got.clamped_evals) == int(full.clamped_evals) == 0

    want = jm.fit(locs, jnp.asarray(z), jm.MLEConfig(**FIT, gen="xla"))
    assert (got.n_iters, got.n_evals) == (int(want.n_iters), int(want.n_evals))
    assert float(got.loglik) == pytest.approx(float(want.loglik), rel=1e-9)
    np.testing.assert_allclose(
        x, np.asarray(jm.pack_params(want.params, False)), rtol=0, atol=1e-7
    )


def test_fit_replays_finished_starts_with_their_counters(tmp_path, monkeypatch):
    """Re-running a finished checkpointed multistart replays every start
    from the manifest with no evaluation, and the best start keeps its
    fault counters (``done_aux``)."""
    locs = uniform_locations(16, seed=2)
    z = np.random.default_rng(1).normal(size=2 * len(locs))
    cfg = tm.MLEConfig(p=2, backend="exact", profile=False, max_iters=4)
    d = str(tmp_path / "fit")
    first = tm.fit(locs, z, cfg, n_starts=2, checkpoint_dir=d, device="cpu")
    assert json.load(open(os.path.join(d, "step_00000001", "manifest.json")))[
        "extra"
    ]["done_aux"] == [[0, 0, 0], [0, 0, 0]]
    with monkeypatch.context() as mp:
        calls = _counting(mp)
        again = tm.fit(locs, z, cfg, n_starts=2, checkpoint_dir=d, device="cpu")
    assert calls == []
    assert float(again.loglik) == float(first.loglik)
    assert (again.n_iters, again.n_evals) == (first.n_iters, first.n_evals)
    for got, want in (
        (again.clamped_evals, first.clamped_evals),
        (again.recovery_retries, first.recovery_retries),
    ):
        assert got is not None and int(got) == int(want)
