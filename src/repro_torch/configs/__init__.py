"""Config registry of the LM port: ``get_arch(name)``.

The reference registry's ten LM architectures.  The geostatistics
configurations are not part of it (ROADMAP Queue 1 item 8).
"""

from .base import LM_SHAPES, ArchConfig, ShapeConfig
from .granite_34b import GRANITE_34B
from .llama4_maverick import LLAMA4_MAVERICK
from .mamba2_780m import MAMBA2_780M
from .mixtral_8x7b import MIXTRAL_8X7B
from .musicgen_medium import MUSICGEN_MEDIUM
from .phi3_mini import PHI3_MINI
from .pixtral_12b import PIXTRAL_12B
from .qwen3_4b import QWEN3_4B
from .recurrentgemma_9b import RECURRENTGEMMA_9B
from .yi_6b import YI_6B

ARCHS = {
    c.name: c
    for c in [
        QWEN3_4B,
        GRANITE_34B,
        YI_6B,
        PHI3_MINI,
        MUSICGEN_MEDIUM,
        MAMBA2_780M,
        MIXTRAL_8X7B,
        LLAMA4_MAVERICK,
        RECURRENTGEMMA_9B,
        PIXTRAL_12B,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
