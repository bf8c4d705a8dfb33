"""Tile compilation, the device tables, and the tile tools (the command
line, the OSMLR exports, capacity planning and the reach audit)."""

from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.tileset import (TileMeta, TileSet,
                                              tables_from_numpy)

__all__ = ["TileMeta", "TileSet", "compile_network", "tables_from_numpy"]
