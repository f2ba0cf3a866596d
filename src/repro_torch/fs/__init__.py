"""Filesystem backends: simulated Lustre (OSTs/pools/DNE/HSM) and POSIX."""
from .base import FsBackend, stat_batch
from .lustrefs import LustreSim, Ost
from .posixfs import PosixFs
from .hsm_backend import HsmBackend

__all__ = ["FsBackend", "LustreSim", "Ost", "PosixFs", "HsmBackend",
           "stat_batch"]
