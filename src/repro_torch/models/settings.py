"""Model-wide switches.

Counterpart of ``repro.models.settings``'s ``FSDP_GATHER_MESH`` and
``fsdp_gather``: while a mesh is set, the model computes on that mesh.
Each layer gathers its weights' "data" (FSDP, ZeRO-3) factor just in time
(``shardspecs.gather_layer_params``) and computes tensor-parallel on the
"model" factor; the embedding, the head and the MoE dispatch read the mesh
from here too.  A model sharded by ``distribution.sharding.shard_params``
runs only under its own mesh; None on the single-device paths.  The
reference's ``UNROLL_SCANS`` (its dry-run's cost accounting) belongs to the
tooling (ROADMAP Queue 1 item 8).
"""

from contextlib import contextmanager

FSDP_GATHER_MESH = None


@contextmanager
def fsdp_gather(mesh):
    """Compute on ``mesh`` inside the block (None: on one device)."""
    global FSDP_GATHER_MESH
    prev = FSDP_GATHER_MESH
    FSDP_GATHER_MESH = mesh
    try:
        yield
    finally:
        FSDP_GATHER_MESH = prev
