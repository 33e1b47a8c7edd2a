"""The core of heat_tpu_torch: devices, types, communication, the DNDarray,
factories, the operations of the array path and ``linalg``'s int8 GEMM."""

from . import linalg
from .arithmetics import *
from .communication import TorchCommunication, get_comm, use_comm
from .devices import Device, cpu, get_device, gpu, use_device
from .dndarray import DNDarray
from .exponential import *
from .factories import *
from .statistics import *
from .types import (
    bool,
    canonical_heat_type,
    float16,
    float32,
    float64,
    bfloat16,
    int8,
    int16,
    int32,
    int64,
    promote_types,
    uint8,
    uint16,
    uint32,
    uint64,
)
