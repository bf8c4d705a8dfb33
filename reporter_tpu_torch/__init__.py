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

# the fleet's entry points, imported at first use (as the JAX package's
# lazy top-level API has them): importing the package stays light
_LAZY = {
    "FleetResidency": ("reporter_tpu_torch.fleet.residency",
                       "FleetResidency"),
    "FleetConfig": ("reporter_tpu_torch.fleet.residency", "FleetConfig"),
    "MetroSLO": ("reporter_tpu_torch.fleet.router", "MetroSLO"),
    "make_fleet_router": ("reporter_tpu_torch.fleet.router",
                          "make_fleet_router"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(
        f"module 'reporter_tpu_torch' has no attribute {name!r}")
