"""The port's host library: the C prepare and walk of match_many
(prepare.cc, walker.cc), the compiler's reach builder (reach.cc) and
their build.

    from reporter_tpu_torch.native import lib    # the loaded ctypes.CDLL

``load_native_lib`` is ``build.load``. ``lib`` is resolved at first
access, so importing this package runs no g++. Unlike the JAX package's
``lib`` (a CDLL or None), it is never None: a missing g++ or a failed
build raises, as nothing falls back to the Python forms.
"""

from reporter_tpu_torch.native.build import load as load_native_lib

__all__ = ["lib", "load_native_lib"]


def __getattr__(name):
    if name == "lib":
        return load_native_lib()
    raise AttributeError(
        f"module 'reporter_tpu_torch.native' has no attribute {name!r}")
