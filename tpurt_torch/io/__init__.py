from tpurt_torch.io.bmp import bmp_bytes, read_bmp, write_bmp  # noqa: F401
from tpurt_torch.io.checkpoint import (  # noqa: F401
    TileAccumulator, config_fingerprint)
