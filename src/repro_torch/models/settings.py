"""Model-wide switches.

Counterpart of ``repro.models.settings``'s ``FSDP_GATHER_MESH`` and
``fsdp_gather``: while a mesh is set, the model computes on that mesh.
Each layer gathers its weights' "data" (FSDP, ZeRO-3) factor just in time
(``shardspecs.gather_layer_params``) and computes tensor-parallel on the
"model" factor; the embedding, the head and the MoE dispatch read the mesh
from here too.  A model sharded by ``distribution.sharding.shard_params``
runs only under its own mesh; None on the single-device paths.  The
reference's ``UNROLL_SCANS``, ``scan_unroll`` and ``unrolled_scans`` have no
counterpart: they exist because XLA's cost analysis counts a loop body
once, while the port's layers are a Python loop that a trace sees whole
(``launch.dryrun``; a difference by design, ROADMAP Queue 3).

``DP_AXES`` (set with the mesh: ``fsdp_gather(mesh, dp_axes=...)``) names
the data-parallel axes the batch is split over where they are not every DP
axis of the mesh: the reference's rule (``shardspecs.dp_axes``) for a batch
that does not divide over them all, ("data",) or none.  Axes left out hold
copies of the rows, and nothing is summed over them.  ``MOE_AT_CAPACITY``
(``moe_at_capacity()``) runs MoE dispatch with static shapes, each expert at
its capacity, as the reference's (E C, d) buffer does: a shape-only trace
(the dry-run, on fake tensors) cannot read how many rows each expert keeps.
"""

from contextlib import contextmanager

FSDP_GATHER_MESH = None
DP_AXES = None
MOE_AT_CAPACITY = False


@contextmanager
def fsdp_gather(mesh, dp_axes=None):
    """Compute on ``mesh`` inside the block (None: on one device), the batch
    split over ``dp_axes`` (None: every DP axis of the mesh)."""
    global FSDP_GATHER_MESH, DP_AXES
    prev = FSDP_GATHER_MESH, DP_AXES
    FSDP_GATHER_MESH = mesh
    DP_AXES = None if dp_axes is None else tuple(dp_axes)
    try:
        yield
    finally:
        FSDP_GATHER_MESH, DP_AXES = prev


@contextmanager
def moe_at_capacity():
    """MoE dispatch at static shapes inside the block (each expert computes
    its capacity's rows; the values of the kept pairs are the same)."""
    global MOE_AT_CAPACITY
    prev = MOE_AT_CAPACITY
    MOE_AT_CAPACITY = True
    try:
        yield
    finally:
        MOE_AT_CAPACITY = prev
