"""Test-support utilities shipped with the library (fault injection)."""

from .faultinject import (  # noqa: F401
    corrupt_diag_tile,
    nan_compress_panel,
    zero_shard,
)
