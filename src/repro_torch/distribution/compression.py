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
forms (``compressed_psum``, ``compressed_psum_leaf``) are ``shard_map``
reductions over a device mesh and belong to the multi-device forms (ROADMAP
Queue 1 item 7).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MESH_REFUSAL = (
    "the compressed psum is a collective over a device mesh: it belongs to "
    "the multi-device forms (ROADMAP Queue 1 item 7); use "
    "quantize_dequantize_psum_sim on one device"
)


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


def compressed_psum_leaf(g, axis_name: str, error):
    raise ValueError(MESH_REFUSAL)


def compressed_psum(tree, mesh, axis_name: str = "pod", errors=None):
    raise ValueError(MESH_REFUSAL)


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
