"""The paper's own workloads as first-class --arch configs (a copy of
``repro.configs.geostat``)."""

from .base import GEOSTAT_SHAPES, GeoStatConfig

GEOSTAT_EXACT = GeoStatConfig(
    name="geostat-exact",
    backend="exact",
    tile_size=4096,  # panel width
    shapes=tuple(GEOSTAT_SHAPES),
)

GEOSTAT_TLR = GeoStatConfig(
    name="geostat-tlr",
    backend="tlr",
    tile_size=2048,  # nb = O(sqrt(pn)) trade-off (paper §5.3)
    max_rank=128,
    tol=1e-7,  # TLR7 default
    # pair-batch factorization (--tlr-block-cyclic 0 re-runs the masked
    # full-grid form)
    block_cyclic=True,
    shapes=tuple(GEOSTAT_SHAPES),
)
