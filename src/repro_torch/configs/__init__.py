"""Config registry of the LM port: ``get_arch(name)``.

The four dense, attention-only architectures of the reference's registry.
The reference's other six LM architectures need modules the port does not
have yet (MoE, SSM, RG-LRU, modality frontends; ROADMAP Queue 1 item 6,
the rest of the LM substrate).
"""

from .base import LM_SHAPES, ArchConfig, ShapeConfig
from .granite_34b import GRANITE_34B
from .phi3_mini import PHI3_MINI
from .qwen3_4b import QWEN3_4B
from .yi_6b import YI_6B

ARCHS = {c.name: c for c in [QWEN3_4B, GRANITE_34B, YI_6B, PHI3_MINI]}

NOT_PORTED = (
    "musicgen-medium",
    "mamba2-780m",
    "mixtral-8x7b",
    "llama4-maverick-400b-a17b",
    "recurrentgemma-9b",
    "pixtral-12b",
)


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise KeyError(
            f"arch {name!r} needs modules not yet ported (MoE, SSM, RG-LRU or a "
            "frontend: ROADMAP Queue 1 item 6, the rest of the LM substrate)"
        )
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
