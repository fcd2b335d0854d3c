"""Architecture and shape configuration (``--arch`` / ``--shape``).

A copy of the LM half of ``repro.configs.base``: ``ShapeConfig``,
``LM_SHAPES`` and ``ArchConfig`` with its ``reduced()`` CPU configuration.
The geostatistics configurations are not part of the LM port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# The LM shape set shared by the reference's ten architectures.
LM_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    source: str  # provenance note [source; verified-tier]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    layer_pattern: tuple = ("attn",)  # cycled: attn | swa | local | ssd | rglru
    mlp_kind: str = "swiglu"  # swiglu | gelu
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: int = 0  # swa/local window size
    # MoE
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # MoE replaces the MLP every k-th layer
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_groups: int = 1
    # RG-LRU (recurrentgemma)
    lru_width: int = 0  # 0 -> d_model
    # Modality frontend (backbone-only archs)
    frontend: str = "none"  # none | audio_stub | vision_stub
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    sub_quadratic: bool = False  # may run long_500k
    shapes: tuple = tuple(LM_SHAPES)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern)

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def supports_shape(self, shape: ShapeConfig) -> bool:
        # pure full attention skips long_500k
        return shape.name != "long_500k" or self.sub_quadratic

    def reduced(self) -> ArchConfig:
        """Small same-family config for CPU tests."""
        period = len(self.layer_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=max(2 * period, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, 4 * self.num_kv_heads // max(self.num_heads, 1)),
            head_dim=32,
            d_ff=256,
            vocab_size=256,
            window=min(self.window, 64) if self.window else 0,
            num_experts=min(self.num_experts, 4) if self.moe else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.moe else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16 if self.ssm_state else 256,
            lru_width=64 if self.lru_width or "rglru" in self.layer_pattern else 0,
            dtype="float32",
        )
