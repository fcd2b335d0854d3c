"""Gradient compression for the slow cross-pod reduction axis.

Counterpart of ``repro.distribution.compression``: int8 block quantisation
with error feedback,

  1. residual-corrected gradient g' = g + e (e: last step's quantisation
     error);
  2. per block of 256 a scale s = max|g'| / 127, q = round(g' / s) in int8
     (half to even, as ``jnp.round``);
  3. dequantise; e' = g' - dequant(q), fed back next step.

``quantize_dequantize_psum_sim`` applies these numerics to gradients that
are already reduced, leaf by leaf (the train step's form).  The collective
forms (``compressed_psum``, ``compressed_psum_leaf``) reduce over the
"pod" axis of a mesh (``launch.mesh.axis_group``): an int32 sum of the
int8 blocks (what crosses the slow link), a sum of the scales and of the
pod count, and each pod's own quantisation error.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

def _quantize(g, block: int = 256):
    """(int8 blocks (nblocks, block), their float32 scales (nblocks, 1))."""
    flat = g.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q, scale, shape, block: int = 256):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compressed_psum_leaf(g, group, error):
    """One leaf: the error-feedback int8 mean over ``group`` (the process
    group of the reduced axis; None for one rank).  (mean in ``g``'s dtype,
    this rank's float32 error)."""
    from ..launch.mesh import group_sum

    gf = g.to(torch.float32) + error
    q, scale = _quantize(gf)
    qsum = group_sum(q.to(torch.int32), group)  # the slow hop, in integers
    ssum = group_sum(scale.clone(), group)
    npods = group_sum(torch.ones((), dtype=torch.float32, device=g.device), group)
    # the mean of the pods' dequantised contributions: their scales differ,
    # so the mean scale stands in for them (the usual approximation)
    mean = _dequantize(qsum, ssum / npods, g.shape) / npods
    new_error = gf - _dequantize(q, scale, g.shape)  # this pod's own error
    return mean.to(g.dtype), new_error


def compressed_psum(tree, mesh, axis_name: str = "pod", errors=None):
    """The error-feedback compressed mean over ``axis_name`` of ``mesh`` of
    a list of gradients: (means, new float32 errors), one a gradient;
    ``errors`` None starts from zeros.  Every rank of the mesh calls it."""
    from ..launch.mesh import axis_group

    group = axis_group(mesh, axis_name)
    if errors is None:
        errors = [
            torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in tree
        ]
    out = [compressed_psum_leaf(g, group, e) for g, e in zip(tree, errors, strict=True)]
    return [m for m, _ in out], [e for _, e in out]


def quantize_dequantize_psum_sim(grads, errors):
    """(dequantised gradients in their dtypes, new float32 errors), one of
    each a gradient; ``errors`` None starts from zeros."""
    if errors is None:
        errors = [
            torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in grads
        ]
    new_grads, new_errors = [], []
    for g, e in zip(grads, errors, strict=True):
        gf = g.to(torch.float32) + e
        q, s = _quantize(gf)
        deq = _dequantize(q, s, g.shape)
        new_grads.append(deq.to(g.dtype))
        new_errors.append(gf - deq)
    return new_grads, new_errors
