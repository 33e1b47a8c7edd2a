"""The core of heat_tpu_torch: devices, types, communication, the DNDarray,
factories, the elementwise (arithmetic, exponential, trigonometric,
complex, rounding, relational and logical) operations, indexing, the
manipulations, printing, the statistics, ``random``, ``linalg``, I/O, the
estimator bases and the validation helpers."""

from . import constants, io, linalg, random, tiling, version
from .arithmetics import *
from .communication import TorchCommunication, get_comm, sanitize_comm, use_comm
from .complex_math import *
from .constants import *
from .devices import Device, cpu, get_device, gpu, sanitize_device, use_device
from .dndarray import DNDarray
from .exponential import *
from .factories import *
from .indexing import *
from .io import *
from .linalg import *
from .logical import *
from .manipulations import *
from .memory import *
from .printing import *
from .relational import *
from .rounding import *
from .statistics import *
from .trigonometrics import *
from .version import version as __version__
from .base import *
from .sanitation import *
from .stride_tricks import *
from .tiling import *
from .types import *
