"""Derivative-free optimization (the NLOPT role in the paper's stack).

Counterpart of ``repro.core.optimize``: a Nelder–Mead simplex that is
NaN-aware, resumable and threads an auxiliary tree of counters.  The
reference runs it as a ``lax.while_loop`` whose body is a ``lax.cond``
tree; here it is a host loop with the same branches, the same evaluation
and iteration counts and the same stable ordering, so from the same start
and objective the two follow the same simplex path.  The simplex and the
values live on the CPU in the start's dtype; the objective may compute
on the card and return a 0-d tensor there.

* Every objective value is sanitised on entry: a non-finite evaluation is
  stored as ``+inf`` so it can never poison the reflect/expand/contract
  ordering.
* When any vertex holds a non-finite value the iteration performs a
  re-centering shrink toward the best vertex instead of a normal step.
* ``has_aux`` threads an auxiliary tree (tensors, or tuples of them, such
  as ``mle.ObjectiveAux``) out of every evaluation; the running sum is
  returned on ``NMResult.aux``.
* ``init_state`` / ``NMResult.state`` make the loop resumable; the
  counters carry on, so ``max_iters`` is a total.  A state restored from a
  checkpoint carries its counters as 0-d tensors; they are read with
  ``int()``.  ``multistart_nelder_mead`` uses this for crash-tolerant
  multistart MLE (``checkpoint_dir``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..checkpointing.checkpoint import CheckpointManager


class NMState(NamedTuple):
    simplex: torch.Tensor  # (m+1, m) sorted by value
    values: torch.Tensor  # (m+1,)
    n_evals: int
    n_iters: int
    aux: object = None  # running sum of per-eval aux (0-d int32 if none)


class NMResult(NamedTuple):
    x: torch.Tensor
    value: torch.Tensor
    n_evals: int
    n_iters: int
    converged: bool
    aux: object = None  # summed aux tree (only when has_aux=True)
    state: NMState | None = None  # final loop state (resume handle)


def _tree_map(fn, *trees):
    head = trees[0]
    if isinstance(head, tuple):
        parts = [_tree_map(fn, *leaves) for leaves in zip(*trees)]
        return type(head)(*parts) if hasattr(head, "_fields") else type(head)(parts)
    return fn(*trees)


def _tree_add(a, b):
    return _tree_map(torch.add, a, b)


def _tree_sum(auxs):
    out = auxs[0]
    for aux in auxs[1:]:
        out = _tree_add(out, aux)
    return out


def _order(simplex, values):
    idx = torch.argsort(values, stable=True)
    return simplex[idx], values[idx]


def _wrap_eval(fn: Callable, has_aux: bool, dtype: torch.dtype):
    """Sanitising evaluation: returns (value, aux) on the CPU, NaN/inf -> +inf."""

    def ev(x):
        out = fn(x)
        if has_aux:
            val, aux = out
            aux = _tree_map(lambda t: torch.as_tensor(t).detach().cpu(), aux)
        else:
            val, aux = out, torch.zeros((), dtype=torch.int32)
        val = torch.as_tensor(val).detach().to("cpu", dtype)
        val = torch.where(torch.isfinite(val), val, torch.inf)
        return val, aux

    return ev


def _eval_all(ev, simplex):
    vals, auxs = zip(*(ev(x) for x in simplex))
    return torch.stack(vals), _tree_sum(auxs)


def _start(x0) -> torch.Tensor:
    x0 = torch.as_tensor(x0).detach().cpu()
    return x0 if x0.is_floating_point() else x0.to(torch.float64)


def nm_init_state(
    fn: Callable, x0, *, initial_radius: float = 0.25, has_aux: bool = False
) -> NMState:
    """Build (and evaluate) the initial simplex around ``x0``."""
    x0 = _start(x0)
    ev = _wrap_eval(fn, has_aux, x0.dtype)
    m = x0.shape[0]
    ones = torch.ones_like(x0)
    steps = initial_radius * torch.where(torch.abs(x0) > 1e-8, torch.abs(x0), ones)
    simplex = torch.cat([x0[None], x0[None] + torch.diag(steps)], dim=0)
    values, aux = _eval_all(ev, simplex)
    simplex, values = _order(simplex, values)
    return NMState(simplex, values, m + 1, 0, aux)


def _centroid(simplex):
    """Mean of all vertices but the worst, summed in vertex order."""
    total = simplex[0].clone()
    for row in simplex[1:-1]:
        total = total + row
    return total / (simplex.shape[0] - 1)


def nelder_mead(
    fn: Callable,
    x0,
    *,
    max_iters: int = 200,
    initial_radius: float = 0.25,
    xtol: float = 1e-6,
    ftol: float = 1e-8,
    has_aux: bool = False,
    init_state: NMState | None = None,
) -> NMResult:
    """Minimize ``fn`` (scalar) from x0 (shape (m,)).

    With ``has_aux=True`` the objective returns ``(value, aux_tree)`` and
    the sum of every evaluation's aux is returned on ``result.aux``.
    ``init_state`` resumes a previous run's ``result.state`` (the iteration
    and evaluation counters continue, so ``max_iters`` is a total cap).
    """
    x0 = _start(x0)
    ev = _wrap_eval(fn, has_aux, x0.dtype)
    m = x0.shape[0]
    if init_state is None:
        state = nm_init_state(fn, x0, initial_radius=initial_radius, has_aux=has_aux)
    else:
        state = init_state
    alpha, gamma, rho_c, shrink_c = 1.0, 2.0, 0.5, 0.5
    simplex, values = state.simplex, state.values
    n_evals, n_iters, aux = int(state.n_evals), int(state.n_iters), state.aux

    def running():
        spread_f = float(values[-1] - values[0])
        spread_x = float(torch.max(torch.abs(simplex - simplex[0:1])))
        return n_iters < max_iters and (spread_f > ftol or spread_x > xtol)

    while running():
        if not bool(torch.isfinite(values).all()):
            # A vertex went non-finite (sanitised to +inf): pull the whole
            # simplex toward the best vertex and re-evaluate everything.
            s = simplex[0:1] + shrink_c * (simplex - simplex[0:1])
            v, aux_s = _eval_all(ev, s)
            simplex, values = _order(s, v)
            n_evals += m + 1
            n_iters += 1
            aux = _tree_add(aux, aux_s)
            continue

        centroid = _centroid(simplex)
        worst = simplex[-1]
        f_best, f_second, f_worst = values[0], values[-2], values[-1]
        xr = centroid + alpha * (centroid - worst)
        fr, aux_r = ev(xr)
        zero_aux = _tree_map(torch.zeros_like, aux_r)
        if fr < f_best:  # expand
            xe = centroid + gamma * (xr - centroid)
            fe, aux_b = ev(xe)
            new_pt, new_f = (xe, fe) if fe < fr else (xr, fr)
            accepted, nev = True, 2
        elif fr < f_second:  # accept the reflection
            new_pt, new_f, accepted, nev, aux_b = xr, fr, True, 1, zero_aux
        elif fr < f_worst:  # outside contraction
            new_pt = centroid + rho_c * (xr - centroid)
            new_f, aux_b = ev(new_pt)
            accepted, nev = bool(new_f <= fr), 2
        else:  # inside contraction
            new_pt = centroid - rho_c * (centroid - worst)
            new_f, aux_b = ev(new_pt)
            accepted, nev = bool(new_f < f_worst), 2

        if accepted:
            s, v = simplex.clone(), values.clone()
            s[-1], v[-1] = new_pt, new_f
            spent, aux_s = nev, zero_aux
        else:
            s = simplex[0:1] + shrink_c * (simplex - simplex[0:1])
            v, aux_s = _eval_all(ev, s)
            v[0] = values[0]  # best vertex unchanged
            spent = nev + m
        simplex, values = _order(s, v)
        n_evals += spent + 1
        n_iters += 1
        aux = _tree_add(_tree_add(aux, aux_r), _tree_add(aux_b, aux_s))

    final = NMState(simplex, values, n_evals, n_iters, aux)
    return NMResult(
        simplex[0],
        values[0],
        n_evals,
        n_iters,
        n_iters < max_iters,
        aux if has_aux else None,
        final,
    )


def _aux_to_json(aux):
    """A summed aux tree as nested lists of numbers (for a manifest)."""
    if isinstance(aux, tuple):
        return [_aux_to_json(leaf) for leaf in aux]
    return torch.as_tensor(aux).tolist()


def _aux_from_json(template, values):
    """The inverse of ``_aux_to_json``, in ``template``'s structure."""
    if isinstance(template, tuple):
        parts = [_aux_from_json(t, v) for t, v in zip(template, values)]
        if hasattr(template, "_fields"):
            return type(template)(*parts)
        return type(template)(parts)
    return torch.tensor(values, dtype=template.dtype)


def multistart_nelder_mead(
    fn: Callable,
    x0s,
    *,
    checkpoint_dir=None,
    checkpoint_every: int = 0,
    has_aux: bool = False,
    aux_template=None,
    max_iters: int = 200,
    **kwargs,
) -> NMResult:
    """Run Nelder–Mead from several starts and keep the best (the first of
    equal values).

    With ``checkpoint_dir`` set, progress is checkpointed so a crashed
    multistart resumes where it left off: completed starts are replayed
    from the manifest, and the in-progress start's simplex state is
    restored and continued.  ``checkpoint_every`` bounds how many
    iterations run between saves (0 = one save per completed start).  The
    layout and leaf names are the reference's, so either package resumes
    the other's checkpoint.

    ``aux_template`` (port only) is a zero tree of the aux that ``fn``
    returns with ``has_aux``: a resume restores the checkpoint's aux into
    its structure.  Without it a resume evaluates ``fn`` once at the first
    start to learn the structure.  Each finished start's summed aux is
    kept under the manifest's ``done_aux`` key (which the reference does
    not read), so a replayed start keeps its counters.
    """
    x0s = [_start(x0) for x0 in x0s]
    mgr = CheckpointManager(checkpoint_dir) if checkpoint_dir is not None else None
    segment = max_iters
    if mgr is not None and checkpoint_every > 0:
        segment = checkpoint_every
    start_idx, iters_done, done_results, done_aux = 0, 0, [], []
    state = None
    latest = mgr.latest_step() if mgr is not None else None
    if has_aux and aux_template is None and latest is not None:
        aux_template = _wrap_eval(fn, True, x0s[0].dtype)(x0s[0])[1]
    if not has_aux:
        aux_template = torch.zeros((), dtype=torch.int32)
    if latest is not None:
        m = x0s[0].shape[0]
        simplex = torch.zeros((m + 1, m), dtype=x0s[0].dtype)
        template = NMState(simplex, simplex[:, 0].clone(), 0, 0, aux_template)
        tree, manifest = mgr.restore({"state": template}, step=latest)
        extra = manifest["extra"]
        start_idx = int(extra["start_index"])
        iters_done = int(extra["iters_done"])
        done_results = [tuple(r) for r in extra["done_values"]]
        done_aux = extra.get("done_aux", [None] * len(done_results))
        state = tree["state"] if iters_done > 0 else None

    results = [
        NMResult(
            torch.tensor(x, dtype=x0s[0].dtype),
            torch.tensor(v, dtype=x0s[0].dtype),
            int(ne),
            int(ni),
            bool(c),
            None if not has_aux or a is None else _aux_from_json(aux_template, a),
        )
        for (x, v, ne, ni, c), a in zip(done_results, done_aux)
    ]
    step = latest if latest is not None else -1
    for i in range(start_idx, len(x0s)):
        while True:
            cap = min(max_iters, iters_done + segment)
            res = nelder_mead(
                fn, x0s[i], max_iters=cap, has_aux=has_aux, init_state=state, **kwargs
            )
            state = res.state
            iters_done = int(state.n_iters)
            finished = bool(res.converged) or iters_done >= max_iters
            if finished:
                results.append(res)
                done_results.append(
                    (
                        res.x.tolist(),
                        float(res.value),
                        int(res.n_evals),
                        int(res.n_iters),
                        bool(res.converged),
                    )
                )
                done_aux.append(_aux_to_json(res.aux) if has_aux else None)
            if mgr is not None:
                step += 1
                mgr.save(
                    step,
                    {"state": state},
                    extra={
                        "start_index": i + 1 if finished else i,
                        "iters_done": 0 if finished else iters_done,
                        "done_values": done_results,
                        "done_aux": done_aux,
                    },
                )
            if finished:
                state, iters_done = None, 0
                break

    best = int(torch.argmin(torch.stack([r.value for r in results])))
    return results[best]
