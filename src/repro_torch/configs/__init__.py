"""Config registry: ``get_arch(name)``, ``get_shape(arch, name)`` and
``iter_cells()``.

The reference registry's ten LM architectures and its two geostatistics
configurations, with the same cells.
"""

from .base import (
    GEOSTAT_SHAPES,
    LM_SHAPES,
    ArchConfig,
    GeoStatConfig,
    GeoStatShape,
    ShapeConfig,
)
from .geostat import GEOSTAT_EXACT, GEOSTAT_TLR
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
        GEOSTAT_EXACT,
        GEOSTAT_TLR,
    ]
}

LM_ARCH_NAMES = [c for c in ARCHS if not c.startswith("geostat")]


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(arch, name: str):
    """The shape ``name`` of ``arch`` (a config or its name)."""
    if isinstance(arch, str):
        arch = get_arch(arch)
    if getattr(arch, "family", "") == "geostat":
        return GEOSTAT_SHAPES[name]
    return LM_SHAPES[name]


def iter_cells():
    """Every (arch, shape, supported) cell, geostatistics included."""
    for arch in ARCHS.values():
        shapes = GEOSTAT_SHAPES if arch.family == "geostat" else LM_SHAPES
        for shape in shapes.values():
            yield arch, shape, arch.supports_shape(shape)
