"""Roofline model of a dry-run cell on the H100 (counterpart of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh), in seconds, each from the counts of
one rank that the dry-run traced (``launch.dryrun``):

  compute    = FLOPs per rank / the card's peak at the cell's compute dtype
  memory     = bytes per rank / HBM bandwidth
  collective = sum over mesh axes of that axis's collective bytes per rank
               / the link its group spans

The hardware model is the datasheet of the NVIDIA H100 80GB HBM3 (SXM5,
700.00 W), not a measurement: dense peaks of 989e12 FLOP/s in BF16, 495e12
in TF32, 67e12 in FP32 and 67e12 in FP64 on the DMMA tensor cores; 3.35e12
B/s of HBM3; NVLink at 450e9 B/s a direction between the 8 GPUs of a node,
and 50e9 B/s a GPU between nodes (400 Gb/s).  A collective group whose ranks
all lie in one node of 8 consecutive ranks runs at NVLink's rate, any other
at the inter-node rate: on the (16, 16) mesh with "model" innermost a
"model" group spans two nodes, a "data" group sixteen.

The reference parses XLA's compiled HLO for its collective bytes
(``collective_bytes``, ``bytes_of_type``, ``cost_analysis_dict``); the port
has no HLO and counts each collective where it is issued
(``launch.mesh.count_collectives``), a difference by design.  The pure
functions of the model (``lm_param_counts``, ``lm_model_flops``,
``tlr_pair_update_stats``, ``tlr_recompress_temp_model``,
``tlr_compress_temp_model``, ``geostat_model_flops``) give the reference's
values.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 80GB HBM3, 700.00 W: SXM5 datasheet figures, not measured.
CARD = "NVIDIA H100 80GB HBM3, 700.00 W (SXM5 datasheet)"
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
    "float64": 67e12,  # DMMA (FP64 tensor cores)
}
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s a direction, inside a node
NODE_BW = 50e9  # bytes/s a GPU across nodes (400 Gb/s)
NODE_SIZE = 8  # GPUs a node
HBM_BYTES = 80e9  # device memory a rank


def peak_flops(dtype: str) -> float:
    """The card's dense peak at a compute dtype ("bfloat16", "float32", ...)."""
    if dtype not in PEAK_FLOPS:
        raise KeyError(f"no peak for dtype {dtype!r}; known: {sorted(PEAK_FLOPS)}")
    return PEAK_FLOPS[dtype]


def link_bw(group_ranks) -> float:
    """The per-GPU rate of a collective over the global ranks
    ``group_ranks``: NVLink inside one node of ``NODE_SIZE`` consecutive
    ranks, else the inter-node rate."""
    nodes = {int(r) // NODE_SIZE for r in group_ranks}
    return NVLINK_BW if len(nodes) <= 1 else NODE_BW


def collective_seconds(by_axis: dict) -> float:
    """The collective term: ``by_axis`` maps a mesh-axis key to
    ``{"bytes": B, "link_bw": rate}``, each axis's bytes at its link."""
    return sum(v["bytes"] / v["link_bw"] for v in by_axis.values() if v["bytes"])


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float  # the traced FLOPs of one rank
    hlo_bytes_per_chip: float  # the dispatched ops' inputs and outputs
    collective_bytes_per_chip: float
    collective_breakdown: dict  # bytes by kind, and by mesh axis
    model_flops_global: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    useful_flops_ratio: float  # MODEL_FLOPS / (chips * FLOPs a rank)
    memory_stats: dict
    compute_dtype: str = "bfloat16"

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    counts: dict,
    model_flops_global: float,
    *,
    compute_dtype: str,
    memory_stats: dict | None = None,
) -> RooflineReport:
    """The roofline of one traced rank.  ``counts``: ``flops``, ``bytes``
    and ``collectives`` (``count_collectives``' dict: ``by_kind`` and
    ``by_axis``, each axis with its ``bytes`` and ``link_bw``)."""
    flops = float(counts["flops"])
    byts = float(counts["bytes"])
    coll = counts["collectives"]
    coll_bytes = float(sum(v["bytes"] for v in coll["by_axis"].values()))
    compute_s = flops / peak_flops(compute_dtype)
    memory_s = byts / HBM_BW
    collective_s = collective_seconds(coll["by_axis"])
    dominant = max(
        (("compute", compute_s), ("memory", memory_s), ("collective", collective_s)),
        key=lambda kv: kv[1],
    )[0]
    useful = model_flops_global / max(flops * chips, 1.0)
    breakdown = dict(coll["by_kind"])
    breakdown["by_axis"] = {k: v["bytes"] for k, v in coll["by_axis"].items()}
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_flops_per_chip=flops,
        hlo_bytes_per_chip=byts,
        collective_bytes_per_chip=coll_bytes,
        collective_breakdown=breakdown,
        model_flops_global=model_flops_global,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        useful_flops_ratio=useful,
        memory_stats=dict(memory_stats or {}),
        compute_dtype=compute_dtype,
    )


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (the "useful work" yardstick)
# ---------------------------------------------------------------------------


def lm_param_counts(cfg) -> dict:
    """Analytic parameter counts (total and active-per-token)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    per_layer_attn = d * hd * (h + 2 * kv) + h * hd * d
    mlp_dense = d * cfg.d_ff * (3 if cfg.mlp_kind == "swiglu" else 2)
    total = 0
    active = 0
    from ..models.transformer import block_spec

    spec = block_spec(cfg)
    seq = [spec[i % len(spec)] for i in range(cfg.num_layers)]
    for kind, use_moe in seq:
        if kind in ("attn", "swa", "local"):
            total += per_layer_attn
            active += per_layer_attn
            if use_moe:
                expert = mlp_dense
                total += cfg.num_experts * expert + d * cfg.num_experts
                active += cfg.experts_per_token * expert
                if cfg.moe_shared_expert:
                    total += expert
                    active += expert
            else:
                total += mlp_dense
                active += mlp_dense
        elif kind == "ssd":
            d_in = cfg.ssm_expand * d
            heads = d_in // cfg.ssm_head_dim
            proj = d * (2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state + heads)
            ssm = proj + d_in * d
            total += ssm
            active += ssm
        elif kind == "rglru":
            lw = cfg.lru_width or d
            rec = 2 * d * lw + 2 * lw * lw + lw * d
            total += rec + mlp_dense
            active += rec + mlp_dense
    embed = cfg.vocab_size * d
    total += embed if cfg.tie_embeddings else 2 * embed
    active += embed if cfg.tie_embeddings else 2 * embed
    return dict(total=total, active=active)


def lm_model_flops(cfg, shape) -> float:
    """Global useful flops for one step of the given shape.

    train: 6 * N_active * tokens  (fwd 2N + bwd 4N)
    prefill: 2 * N_active * tokens + attention term
    decode: 2 * N_active * batch + attention-over-cache term
    """
    counts = lm_param_counts(cfg)
    n_act = counts["active"]
    b, s = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    attn_layers = sum(
        1
        for k in (
            cfg.layer_pattern[i % len(cfg.layer_pattern)]
            for i in range(cfg.num_layers)
        )
        if k in ("attn", "swa", "local")
    )
    if shape.kind == "train":
        flops = 6.0 * n_act * b * s
        eff_s = min(s, cfg.window) if cfg.window else s
        flops += 3 * 2 * 2 * b * s * eff_s * cfg.num_heads * hd * attn_layers / 2
        return flops
    if shape.kind == "prefill":
        flops = 2.0 * n_act * b * s
        eff_s = min(s, cfg.window) if cfg.window else s
        flops += 2 * 2 * b * s * eff_s * cfg.num_heads * hd * attn_layers / 2
        return flops
    # decode: one token against a seq_len cache
    flops = 2.0 * n_act * b
    eff_s = min(s, cfg.window) if cfg.window else s
    flops += 2 * 2 * b * eff_s * cfg.num_heads * hd * attn_layers
    return flops


def tlr_pair_update_stats(n_tiles: int, super_panels: int = 1, n_shards: int = 1) -> dict:
    """Closed-form GEMM + recompress pair-update counts of one TLR
    factorization, by batching form: ``live`` (the tasks the exact triangle
    needs, C(T, 3)), ``masked`` (the masked full-grid batch, ~6x live at
    S = 1) and ``pair`` (the strict-lower pair batch padded to a multiple
    of ``n_shards``, ~2.4x live).  ``super_panels`` = S > 1 shrinks the
    live slice every outer step for both forms."""
    T, S = n_tiles, max(super_panels, 1)
    if T % S:
        raise ValueError(f"super_panels={S} must divide n_tiles={T}")
    chunk = T // S
    live = T * (T - 1) * (T - 2) // 6
    masked = pair = 0
    for s in range(S):
        ts = T - s * chunk  # live slice width
        steps = chunk - 1 if s == S - 1 else chunk
        n_pairs = ts * (ts - 1) // 2
        padded = -(-n_pairs // n_shards) * n_shards if n_pairs else 0
        masked += steps * ts * ts
        pair += steps * padded
    return dict(
        live_updates=live,
        masked_updates=masked,
        pair_updates=pair,
        masked_overcompute=masked / max(live, 1),
        pair_overcompute=pair / max(live, 1),
        pair_vs_masked=masked / max(pair, 1),
    )


def tlr_recompress_temp_model(
    n_tiles: int, tile_size: int, kmax: int, n_shards: int = 1, itemsize: int = 4
) -> dict:
    """Closed-form per-rank working set of the GEMM-phase recompress batch:
    each live pair slot holds the (nb, 2k) concat pair and its two Q
    factors, the (2k, 2k) R/R^T/core triangle and the core SVD outputs;
    replicated, every rank holds the padded batch, sharded over the pair
    axis each holds padded / S slots."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards}")
    pairs = n_tiles * (n_tiles - 1) // 2
    padded = -(-pairs // n_shards) * n_shards if pairs else 0
    nb, k2 = tile_size, 2 * kmax
    per_pair = (
        4 * nb * k2  # U/V concats + their Q factors
        + 3 * k2 * k2  # R_u, R_v, core
        + 2 * k2 * k2
        + k2  # core SVD U, V^T, singular values
    ) * itemsize
    return dict(
        pairs=pairs,
        padded_pairs=padded,
        per_pair_bytes=per_pair,
        replicated_bytes=padded * per_pair,
        sharded_bytes=(padded // n_shards) * per_pair,
        shrink=float(n_shards),
    )


def tlr_compress_temp_model(
    n_tiles: int,
    tile_size: int,
    kmax: int,
    col_block: int = 1,
    n_shards: int = 1,
    itemsize: int = 4,
) -> dict:
    """Closed-form per-rank working set of one compress step's truncation
    SVD by placement: replicated, the (m, cb nb) GEN panel plus cb T tiles
    of SVD workspace on every rank; sharded, cb ceil((T-1)/S) tiles a step,
    and over the sweep the rank's ~T(T-1)/(2S) owned tiles
    (``gen_tiles_owned``) against the per-column sweep's T ceil((T-1)/S)
    candidates (``gen_tiles_candidate``)."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards}")
    T, nb, cb = n_tiles, tile_size, col_block
    m = T * nb
    per_tile = (
        3 * nb * nb + nb  # tile + SVD U, V^T, s
        + 2 * nb * kmax  # truncated padded factors
    ) * itemsize
    own = -(-max(T - 1, 1) // n_shards)
    n_pairs = T * (T - 1) // 2
    pps = max(-(-n_pairs // n_shards), 1)
    candidate = T * own
    return dict(
        tiles_per_step=cb * T,
        tiles_per_step_sharded=cb * own,
        per_tile_bytes=per_tile,
        gen_tiles_owned=pps,
        gen_tiles_candidate=candidate,
        gen_shrink=candidate / max(pps, 1),
        replicated_bytes=m * cb * nb * itemsize + cb * T * per_tile,
        sharded_bytes=cb * own * per_tile,
        shrink=(m * cb * nb * itemsize + cb * T * per_tile)
        / max(cb * own * per_tile, 1),
    )


def serve_predictions_per_sec(
    flops: float, byts: float, coll_s: float, batch: int, *, compute_dtype="float32"
) -> float:
    """Roofline decode throughput of one serving predict batch: batch /
    max(compute, memory, collective time) of the phase's per-rank counts
    (``coll_s``: its collective term in seconds)."""
    t = max(flops / peak_flops(compute_dtype), byts / HBM_BW, coll_s)
    return batch / max(t, 1e-12)


def geostat_model_flops(shape, backend: str, tile_size: int, max_rank: int) -> float:
    """Useful flops of one MLE iteration (or a cokriging prediction batch).

    exact: (1/3) m^3 Cholesky + m^2 solve     (m = p*n)
    tlr:   GEN (~12 flops a Sigma entry) + compression SVDs ((8/3) nb^3 a
           strict-lower tile) + T^3/6 TLR-MM tasks of 36 nb kmax^2 + T dense
           POTRFs + the recompression QR/SVD (2 QRs of (nb, 2k)).
    predict: exact Cholesky + 2 triangular solves for 1 + npred*p RHS.
    """
    m = shape.matrix_dim
    if shape.kind == "predict":
        nrhs = 1 + shape.n_pred * shape.p
        return m**3 / 3.0 + 2.0 * m * m * nrhs
    if backend == "exact":
        return m**3 / 3.0 + 2.0 * m * m
    nb, k = tile_size, max_rank
    t = m // nb
    gen = 12.0 * m * m
    svd = (t * (t - 1) / 2.0) * (8.0 / 3.0) * nb**3
    tlr_mm = (t**3 / 6.0) * 36.0 * nb * k * k
    potrf = t * nb**3 / 3.0
    recompress = (t**3 / 6.0) * 2 * (2 * nb * (2 * k) ** 2)
    return gen + svd + tlr_mm + potrf + recompress


def format_report_row(r: RooflineReport) -> str:
    return (
        f"{r.arch:28s} {r.shape:12s} {r.mesh:8s} "
        f"compute={r.compute_s:9.3e}s memory={r.memory_s:9.3e}s "
        f"collective={r.collective_s:9.3e}s dominant={r.dominant:10s} "
        f"useful={r.useful_flops_ratio:6.3f}"
    )
