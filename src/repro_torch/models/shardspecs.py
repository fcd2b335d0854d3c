"""Parameter sharding specs and the FSDP compute gather.

Counterpart of ``repro.models.shardspecs``.  A spec is a tuple with one
entry a dim of the port's parameter: None (not sharded), a mesh axis name,
or a tuple of names.  Storage specs shard layer weights over both axes:
"data" (FSDP, ZeRO-3) and "model" (tensor and expert parallelism).  At
compute time each layer gathers the "data" factor just in time
(``gather_layer_params``), which is ZeRO-3's gather of the weights a layer
at a time, and computes tensor-parallel on the "model" factor that
``compute_spec`` keeps.

The tables are the reference's (``src/repro/models/shardspecs.py``) in the
port's layouts: an ``nn.Linear`` holds the transpose of the reference's
(in, out) matrix, so its spec is the reference's reversed (the reference's
``wq`` P("data", "model") is ``("model", "data")`` on the (out, in)
weight); every other array keeps the reference's layout and spec.  The
port's model holds a list of layers, not the reference's stacked blocks,
so the stacked leading None goes away.

What each layer computes on the "model" factor (``models.attention``,
``models.mlp``, ``models.moe``):

* attention: ``wq``/``wk``/``wv`` column-parallel (this rank's heads and
  the KV heads they read), ``wo`` row-parallel; where the model axis does
  not divide the KV heads, or the query heads (``heads_uneven``), those
  weights are gathered over "model" and each rank takes its rows;
* mlp: ``w_gate``/``w_up`` column-parallel, ``w_down`` row-parallel;
* moe: experts over "model" (EP) where ``PRODUCTION_TP`` divides their
  number, else tensor-parallel inside each expert;
* ssd and rglru mixers gather their "model" factor too and compute whole
  on every rank: ``w_in`` shards a packed z/x/B/C/dt axis, which does not
  split along its parts (a difference by design, ROADMAP).
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

from torch import nn

# Production tensor-parallel degree (the "model" axis is 16 on the
# reference's single-pod and multi-pod meshes).  Used only for
# divisibility decisions, as in the reference.
PRODUCTION_TP = 16

# The port's (out, in) linear weights: column-parallel (d -> width over
# "model") and row-parallel (width over "model" -> d), FSDP on d.
COLUMN = ("model", "data")
ROW = ("data", "model")

# Replicated parameters applied to a head-sharded activation: each rank's
# gradient is the part of its heads, summed over "model".
MODEL_SUMMED = ("q_norm", "k_norm")

RECURRENT_MIXERS = ("ssm", "rglru")


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch is sharded over (the DP axes; none
    without a mesh).  While ``settings.fsdp_gather(mesh, dp_axes=...)``
    names fewer for this mesh, those."""
    if mesh is None:
        return ()
    from . import settings

    if settings.DP_AXES is not None and settings.FSDP_GATHER_MESH is mesh:
        return settings.DP_AXES
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def dp_axes(mesh, batch: int) -> tuple:
    """The DP axes a global batch of ``batch`` rows splits over: every DP
    axis where the batch divides over them all, else ("data",) where it
    divides over that, else none (every rank holds every row; the
    reference's dry-run rule)."""
    if mesh is None:
        return ()
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    size = lambda axes: math.prod(mesh.size(names.index(a)) for a in axes)  # noqa: E731
    if batch % size(dp):
        dp = ("data",) if batch % size(("data",)) == 0 else ()
    return dp


def vocab_parallel(cfg) -> bool:
    """The embedding vocab-parallel and the head column-parallel; else
    (mamba2's 50280) both shard d_model over "model"."""
    return cfg.vocab_size % PRODUCTION_TP == 0


def embed_spec(cfg) -> tuple:
    """The spec of ``embed`` (V, d) and of the head's (V, d) weight."""
    return ("model", None) if vocab_parallel(cfg) else (None, "model")


def attention_specs(cfg) -> dict:
    qn = {"q_norm": (None,), "k_norm": (None,)} if cfg.qk_norm else {}
    return {
        "wq.weight": COLUMN,
        "wk.weight": COLUMN,
        "wv.weight": COLUMN,
        "wo.weight": ROW,
        **qn,
    }


def mlp_specs(cfg, kind: str | None = None) -> dict:
    kind = kind or cfg.mlp_kind
    gate = {"w_gate.weight": COLUMN} if kind == "swiglu" else {}
    return {**gate, "w_up.weight": COLUMN, "w_down.weight": ROW}


def expert_parallel(cfg) -> bool:
    """Experts over "model" (llama4: 128); else tensor-parallel inside each
    expert (mixtral: 8 on a 16-wide axis)."""
    return cfg.num_experts % PRODUCTION_TP == 0


def moe_specs(cfg) -> dict:
    if expert_parallel(cfg):
        experts = {
            "w_gate": ("model", "data", None),  # E -> EP, d_model -> FSDP
            "w_up": ("model", "data", None),
            "w_down": ("model", None, "data"),
        }
    else:
        experts = {
            "w_gate": (None, "data", "model"),
            "w_up": (None, "data", "model"),
            "w_down": (None, "model", "data"),
        }
    shared = {}
    if cfg.moe_shared_expert:
        shared = {f"shared.{k}": v for k, v in mlp_specs(cfg, "swiglu").items()}
    return {"router": (None, None), **experts, **shared}


def ssm_specs(cfg) -> dict:
    return {
        "w_in.weight": COLUMN,
        "conv_w": (None, "model"),
        "conv_b": ("model",),
        "dt_bias": (None,),
        "a_log": (None,),
        "d_skip": (None,),
        "norm_w": ("model",),
        "w_out.weight": ROW,
    }


def rglru_specs(cfg) -> dict:
    return {
        "w_x.weight": COLUMN,
        "w_gate.weight": COLUMN,
        "conv_w": (None, "model"),
        "conv_b": ("model",),
        "w_a": ("model", None),
        "b_a": ("model",),
        "w_i": ("model", None),
        "b_i": ("model",),
        "lam": ("model",),
        "w_out.weight": ROW,
    }


def layer_specs(cfg, kind: str, use_moe: bool) -> dict:
    """Specs of one ``transformer.Layer``'s parameters, by their names in
    it, in its parameter order."""
    out = {"norm1": (None,)}

    def add(prefix, specs):
        out.update({f"{prefix}.{k}": v for k, v in specs.items()})

    if kind in ("attn", "swa", "local"):
        add("attn", attention_specs(cfg))
    elif kind == "ssd":
        add("ssm", ssm_specs(cfg))
    elif kind == "rglru":
        add("rglru", rglru_specs(cfg))
    if kind != "ssd":
        out["norm2"] = (None,)
        if use_moe:
            add("moe", moe_specs(cfg))
        else:
            add("mlp", mlp_specs(cfg))
    return out


def entry_axes(entry) -> tuple:
    """The axis names of a spec entry (None, a name or a tuple of them)."""
    return tuple(n for n in (entry if isinstance(entry, tuple) else (entry,)) if n)


def compute_spec(spec):
    """Storage spec -> compute spec: strip the FSDP ("data") factor."""
    if spec is None:
        return None
    out = []
    for entry in spec:
        if entry == "data":
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(e for e in entry if e != "data")
            out.append(kept if kept else None)
        else:
            out.append(entry)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """This rank's place on the "model" axis: its process group (None for
    one rank), the axis size and this rank's coordinate."""

    group: object
    size: int
    rank: int


def model_parallel(mesh) -> ModelParallel:
    """The "model" axis of ``mesh`` (one rank without a mesh)."""
    if mesh is None:
        return ModelParallel(None, 1, 0)
    from ..launch.mesh import axis_group, axis_index, axis_size

    return ModelParallel(
        axis_group(mesh, "model"), axis_size(mesh, "model"), axis_index(mesh, "model")
    )


def gather_axes(t, spec, mesh, axes, reduce_grad: bool = True):
    """``t`` (this rank's shard of a tensor of storage spec ``spec``) with
    its dims sharded over any of ``axes`` gathered whole (``gather_dim``);
    ``reduce_grad`` as there."""
    from ..launch.mesh import axis_group, gather_dim

    for dim, entry in enumerate(spec):
        names = entry_axes(entry)
        hit = tuple(n for n in names if n in axes)
        if hit and hit != names:
            raise ValueError(f"dim {dim} of spec {spec}: gather all of {names} or none")
        if hit:
            t = gather_dim(t, dim, axis_group(mesh, hit), reduce_grad)
    return t


def heads_uneven(cfg, tp: ModelParallel | None) -> bool:
    """True where the model axis does not divide the query heads (llama4's
    40 and musicgen's 24 on the production axis of 16): each rank then
    takes its rows of the whole attention weights, ceil(H / size) heads
    in order and the last ranks fewer or none (``attention.head_split``),
    as GSPMD pads an uneven split."""
    return tp is not None and cfg.num_heads % tp.size != 0


def kv_whole(cfg, tp: ModelParallel | None) -> bool:
    """True where the model axis does not divide the KV heads: K and V are
    then computed whole on every rank of the axis (reduced configs' one KV
    head, recurrentgemma's MQA)."""
    return tp is not None and cfg.num_kv_heads % tp.size != 0


def _weights(module: nn.Module, fn, prefix: str = "") -> SimpleNamespace:
    """A namespace with ``module``'s attributes: each parameter as
    ``fn(name, param)``, an ``nn.Linear`` as ``fn`` of its weight, each
    other submodule as its own namespace, the optional weights (None) and
    the layer's ``kind``/``use_moe`` as they are."""
    ns = SimpleNamespace()
    for key in ("kind", "use_moe", "q_norm", "k_norm", "shared", "w_gate"):
        if key in module.__dict__:
            setattr(ns, key, module.__dict__[key])
    for name, p in module.named_parameters(recurse=False):
        setattr(ns, name, fn(prefix + name, p))
    for name, child in module.named_children():
        if isinstance(child, nn.Linear):
            setattr(ns, name, fn(f"{prefix}{name}.weight", child.weight))
        else:
            setattr(ns, name, _weights(child, fn, f"{prefix}{name}."))
    return ns


def gather_layer_params(layer, cfg, kind: str, use_moe: bool, mesh):
    """Every weight of a layer at its compute spec: the "data" factor
    gathered (its gradient reduce-scattered over "data"), and the "model"
    factor also where the layer computes whole on it: the ssd and rglru
    mixers (every rank computes the same gradient: each keeps its slice)
    and where a rank takes its rows of a whole weight: K/V where
    ``kv_whole``, all four attention weights where ``heads_uneven`` (each
    rank's heads give a part of the gradient: summed over "model").  A
    namespace shaped as the layer, a linear's weight where the layer holds
    an ``nn.Linear``."""
    specs = layer_specs(cfg, kind, use_moe)
    tp = model_parallel(mesh)
    kv = kv_whole(cfg, tp)
    uneven = heads_uneven(cfg, tp)

    def one(name, p):
        spec = specs[name]
        t = gather_axes(p, spec, mesh, ("data",))
        mixer = name.split(".", 1)[0]
        if mixer in RECURRENT_MIXERS:
            t = gather_axes(t, compute_spec(spec), mesh, ("model",), reduce_grad=False)
        elif (uneven and mixer == "attn") or (
            kv and name in ("attn.wk.weight", "attn.wv.weight")
        ):
            t = gather_axes(t, compute_spec(spec), mesh, ("model",))
        return t

    return _weights(layer, one)
