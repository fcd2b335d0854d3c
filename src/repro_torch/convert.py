"""Carry the reference package's state across, as numpy arrays.

These take plain arrays (``np.asarray`` of the reference's outputs), so the
port never imports the reference.  Factoring the very TLRMatrix the
reference compressed takes the SVD sign freedom out of a comparison.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .core.covariance import MaternParams
from .core.dist_tlr import PairTLR
from .core.optimize import NMState
from .core.prediction import CokrigeFactor
from .core.tlr import TLRMatrix
from .device import resolve_device
from .distribution.block_cyclic import pair_layout
from .models.transformer import Model, init_model, layer_counts
from .training.optimizer import AdamWState


def params_from_numpy(
    sigma2, a, nu, beta, *, device=None, dtype=torch.float64
) -> MaternParams:
    """``MaternParams`` from arrays: sigma2 (p,), a scalar, nu (p,), beta (p, p)."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    return MaternParams(t(sigma2), t(a), t(nu), t(beta))


def _tensor(x, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=dev)


def tlr_matrix_from_numpy(diag, u, v, ranks, *, device=None) -> TLRMatrix:
    """``TLRMatrix`` from arrays: diag (T, nb, nb), u and v (T, T, nb, kmax),
    ranks (T, T).  Floating arrays keep their dtype, so U/V stored narrow
    by a precision policy stay narrow."""
    dev = resolve_device(device)
    return TLRMatrix(
        _tensor(diag, dev),
        _tensor(u, dev),
        _tensor(v, dev),
        _tensor(ranks, dev, torch.int32),
    )


def pair_tlr_from_numpy(
    diag, u, v, ranks, n_shards: int = 1, *, device=None
) -> PairTLR:
    """``PairTLR`` from the arrays of the reference's: diag (T, nb, nb), u
    and v (length, nb, kmax) pair-major, ranks (length,), and the shard
    count its slots were laid out for.  Floating arrays keep their dtype."""
    dev = resolve_device(device)
    return PairTLR(
        diag=_tensor(diag, dev),
        u=_tensor(u, dev),
        v=_tensor(v, dev),
        ranks=_tensor(ranks, dev, torch.int32),
        n_shards=int(n_shards),
    )


def cokrige_factor_from_numpy(
    diag_l, u, v, ranks, alpha, locs, params, n_shards: int = 1, *, z=None, device=None
) -> CokrigeFactor:
    """A TLR ``CokrigeFactor`` from the arrays of the reference's handle:
    diag_l (T, nb, nb), u and v (length, nb, kmax) pair-major, ranks
    (length,), alpha (m,), locs (n, d); ``params`` a ``MaternParams`` or
    its four arrays (sigma2, a, nu, beta).  The slots may be laid out for
    any shard count (a factor of the reference's mesh forms holds every slot
    of ``pair_layout(T, n_shards)``); their number must match it."""
    T = np.shape(diag_l)[0]
    length = pair_layout(T, n_shards).length
    if np.shape(u)[0] != length:
        raise ValueError(
            f"u holds {np.shape(u)[0]} pair slots; a layout of {T} tiles for "
            f"n_shards={n_shards} has {length}"
        )
    dev = resolve_device(device)
    if not isinstance(params, MaternParams):
        params = params_from_numpy(*params, device=dev)
    return CokrigeFactor(
        diag_l=_tensor(diag_l, dev),
        u=_tensor(u, dev),
        v=_tensor(v, dev),
        ranks=_tensor(ranks, dev, torch.int32),
        alpha=_tensor(alpha, dev),
        locs=_tensor(locs, dev),
        params=params,
        kind="tlr",
        n_shards=n_shards,
        z=None if z is None else _tensor(z, dev),
    )


def nm_state_from_numpy(simplex, values, n_evals, n_iters, aux) -> NMState:
    """A Nelder–Mead ``NMState`` from the reference's state arrays, to resume
    its run: simplex (m+1, m), values (m+1,), the two counters and the
    running aux sum (an int array for a run without aux).  The optimizer's
    state lives on the CPU."""

    def t(x):
        return torch.as_tensor(np.array(x))

    return NMState(t(simplex), t(values), int(n_evals), int(n_iters), t(aux))


def _field(node, name: str):
    """``node[name]`` of a dict, ``node.name`` of anything else (the
    reference's NamedTuples), None where it has no such field."""
    if node is None:
        return None
    if isinstance(node, dict):
        return node.get(name)
    return getattr(node, name, None)


def _copy(param, arr, index=None, transpose=False) -> None:
    a = np.array(arr, dtype=np.float32)  # a copy; bf16 arrays widen exactly
    if index is not None:
        a = a[index]
    t = torch.as_tensor(a.T if transpose else a)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(t.shape)} does not fit {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(t)


def copy_weights(module: nn.Module, src, index=None) -> None:
    """Each weight of ``module`` (a port layer or block: ``Attention``,
    ``MLP``, ``MoE``, ``SSM``, ``RGLRU``, ``Layer``) from the field of
    ``src`` (the reference's params, as numpy arrays) of its name, taking
    entry ``index`` of stacked leaves: a parameter as it lies, an
    ``nn.Linear``'s (out, in) weight from the reference's (in, out) matrix,
    a submodule (the MoE's shared expert) from the field's own fields."""
    for name, param in module.named_parameters(recurse=False):
        _copy(param, _field(src, name), index)
    for name, child in module.named_children():
        if isinstance(child, nn.Linear):
            _copy(child.weight, _field(src, name), index, transpose=True)
        else:
            copy_weights(child, _field(src, name), index)


def lm_params_from_numpy(tree, cfg, *, device=None, dtype=None) -> Model:
    """The port's model holding the weights of the reference's
    ``init_model`` pytree, every leaf passed through ``np.asarray``.

    ``params["blocks"]`` (one entry a pattern position, leaves stacked on a
    leading block axis) and ``params["tail"]`` are unstacked into the
    model's layers, every layer kind's (``AttentionParams``, ``MLPParams``,
    ``MoEParams`` with its shared expert, ``SSMParams``, ``RGLRUParams``);
    the reference's (in, out) matrices that are ``nn.Linear``s here become
    their (out, in) weights, and every other array (the experts' and SSM
    tensors, the RG-LRU gate projections) keeps its layout.  ``dtype``
    defaults to ``cfg.dtype``.
    """
    model = init_model(cfg, device=resolve_device(device))
    if dtype is not None:
        model = model.to(dtype)
    nblocks = layer_counts(cfg)[0]
    period = len(cfg.layer_pattern)
    sources = [(tree["blocks"][j], b) for b in range(nblocks) for j in range(period)]
    sources += [(layer, None) for layer in tree["tail"]]
    if len(sources) != len(model.layers):
        raise ValueError(f"{len(sources)} layers in the tree, {cfg.num_layers} in cfg")
    for layer, (src, index) in zip(model.layers, sources):
        copy_weights(layer, src, index)
    _copy(model.embed, tree["embed"])
    _copy(model.final_norm, tree["final_norm"])
    if model.lm_head is not None:
        _copy(model.lm_head.weight, tree["lm_head"], transpose=True)
    return model


def lm_leaves_from_numpy(tree, cfg, *, device=None) -> list:
    """The leaves of a tree shaped as the reference's LM params (its
    gradients, its optimizer's ``master``, ``m`` or ``v``; numpy arrays),
    as float32 tensors in the port model's parameter order: unstacked and
    transposed as ``lm_params_from_numpy`` does."""
    model = lm_params_from_numpy(tree, cfg, device=device, dtype=torch.float32)
    return [p.detach() for p in model.parameters()]


def adamw_state_from_numpy(state, cfg, *, device=None) -> AdamWState:
    """The port's ``AdamWState`` from the reference's, every tree passed
    through ``np.asarray``: its step, and ``master``, ``m`` and ``v`` mapped
    onto the port's parameters in float32."""
    dev = resolve_device(device)

    def leaves(name):
        return lm_leaves_from_numpy(_field(state, name), cfg, device=dev)

    return AdamWState(
        step=_tensor(_field(state, "step"), dev, torch.int32),
        master=leaves("master"),
        m=leaves("m"),
        v=leaves("v"),
    )
