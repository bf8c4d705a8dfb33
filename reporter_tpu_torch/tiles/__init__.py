"""Tile compilation and the device tables of the dense path."""

from reporter_tpu_torch.tiles.compiler import compile_network
from reporter_tpu_torch.tiles.tileset import TileSet, tables_from_numpy

__all__ = ["TileSet", "compile_network", "tables_from_numpy"]
