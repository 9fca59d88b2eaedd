from . import fd3d, ref
from .fd3d import fd3d_cuda
from .ops import fd3d_step

__all__ = ["fd3d_step", "fd3d_cuda", "fd3d", "ref"]
