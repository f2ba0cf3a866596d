"""The JAX package and the port side by side, for the tests that run one
case on both.

``package(name)`` gathers a package's ``core`` exports, its ``fs`` module
and the submodules the cases reach (``core.policy``, ``core.telemetry``,
``core.types``) into one namespace, so a case written once against ``P``
runs on either. ``P.dev`` holds the keyword arguments a device-taking
constructor needs: ``{"device": "cpu"}`` on the port (its default is the
card), nothing on the reference. ``both(case, ...)`` runs a case on the
reference and then on the port and holds the two results equal; the
reference is imported only there, when a case compares against it.
"""
import importlib
from types import SimpleNamespace

REF, PORT = "repro", "repro_torch"


def package(name: str) -> SimpleNamespace:
    core = importlib.import_module(f"{name}.core")
    fs = importlib.import_module(f"{name}.fs")
    ns = SimpleNamespace(**{k: getattr(core, k) for k in core.__all__})
    ns.__dict__.update({k: getattr(fs, k) for k in fs.__all__})
    ns.name = name
    ns.core, ns.fs = core, fs
    for mod in ("policy", "telemetry", "types"):
        setattr(ns, mod, importlib.import_module(f"{name}.core.{mod}"))
    ns.dev = {"device": "cpu"} if name == PORT else {}
    return ns


def port() -> SimpleNamespace:
    return package(PORT)


def ref() -> SimpleNamespace:
    return package(REF)


def both(case, *args, **kwargs):
    """``case(P, *args, **kwargs)`` on the reference, then on the port:
    the two results must be equal. Returns the port's."""
    want = case(ref(), *args, **kwargs)
    got = case(port(), *args, **kwargs)
    assert got == want, f"{case.__name__}: the port diverged from repro"
    return got
