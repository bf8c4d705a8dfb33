"""reporter_tpu_torch — the PyTorch / CUDA port of reporter_tpu.

Same map matcher (GPS probe traces → OSMLR segment records), same tables
and the same wire format, with the device half in PyTorch and the dense
candidate sweep as a hand-written CUDA kernel for Hopper
(``kernels/sweep_exact.cu``: one ring-fed template, five arms, one
``nvcc``). Module names mirror
the JAX package's so each counterpart is easy to find. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``
(device.resolve_device).
"""

# the top-level API, the JAX package's names (reporter_tpu/__init__.py),
# each imported at first use: importing the package loads no torch
_LAZY = {
    "Config": ("reporter_tpu_torch.config", "Config"),
    "CompilerParams": ("reporter_tpu_torch.config", "CompilerParams"),
    "MatcherParams": ("reporter_tpu_torch.config", "MatcherParams"),
    "SegmentMatcher": ("reporter_tpu_torch.matcher.api", "SegmentMatcher"),
    "MatchBatch": ("reporter_tpu_torch.matcher.api", "MatchBatch"),
    "Trace": ("reporter_tpu_torch.matcher.api", "Trace"),
    "TileSet": ("reporter_tpu_torch.tiles.tileset", "TileSet"),
    "compile_network": ("reporter_tpu_torch.tiles.compiler",
                        "compile_network"),
    "plan_staging": ("reporter_tpu_torch.tiles.capacity", "plan_staging"),
    "generate_city": ("reporter_tpu_torch.netgen.synthetic",
                      "generate_city"),
    "parse_osm_xml": ("reporter_tpu_torch.netgen.osm_xml", "parse_osm_xml"),
    "make_app": ("reporter_tpu_torch.service.app", "make_app"),
    "make_router": ("reporter_tpu_torch.service.router", "make_router"),
    "make_fleet_router": ("reporter_tpu_torch.fleet.router",
                          "make_fleet_router"),
    "FleetResidency": ("reporter_tpu_torch.fleet.residency",
                       "FleetResidency"),
    "FleetConfig": ("reporter_tpu_torch.fleet.residency", "FleetConfig"),
    "MetroSLO": ("reporter_tpu_torch.fleet.router", "MetroSLO"),
    "KafkaProbeConsumer": ("reporter_tpu_torch.streaming.kafka_adapter",
                           "KafkaProbeConsumer"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(
        f"module 'reporter_tpu_torch' has no attribute {name!r}")
