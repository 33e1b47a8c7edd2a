"""Device abstraction over torch devices.

Counterpart of ``heat_tpu/core/devices.py``. The reference Heat binds each
MPI rank to one torch device; so does this package: one process per GPU,
and a :class:`Device` names the torch device that backs the rank-local
tensors. The default is the card. The CPU is used only when the caller
asks for it (``device="cpu"`` or ``use_device("cpu")``); without that
request and without a card, resolving the default raises instead of
quietly running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["Device", "cpu", "gpu", "get_device", "sanitize_device", "use_device"]


class Device:
    """A compute device backing DNDarray storage.

    Parameters
    ----------
    device_type : str
        ``"cpu"`` or ``"gpu"`` (``"cuda"`` is accepted as an alias).
    device_id : int, optional
        Index of a specific card. ``None`` means the process's current CUDA
        device, which is ``cuda:0`` unless the caller set another one.
    """

    def __init__(self, device_type: str, device_id: Optional[int] = None):
        device_type = device_type.strip().lower()
        if device_type == "cuda":
            device_type = "gpu"
        if device_type not in ("cpu", "gpu"):
            raise ValueError(f"device type must be 'cpu' or 'gpu', got {device_type!r}")
        self.__device_type = device_type
        self.__device_id = device_id

    @property
    def device_type(self) -> str:
        return self.__device_type

    @property
    def device_id(self) -> Optional[int]:
        return self.__device_id

    @property
    def torch_device(self) -> torch.device:
        """The torch device for this rank. Raises when a card is asked for
        and none is available."""
        if self.__device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "heat_tpu_torch: no CUDA device is available. Pass device='cpu' "
                "or call heat_tpu_torch.use_device('cpu') to run on the CPU."
            )
        idx = self.__device_id if self.__device_id is not None else torch.cuda.current_device()
        return torch.device("cuda", idx)

    def __eq__(self, other) -> bool:
        if isinstance(other, Device):
            return self.device_type == other.device_type and self.device_id == other.device_id
        return NotImplemented

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self) -> str:
        return f"device({self.__str__()!r})"

    def __str__(self) -> str:
        if self.__device_id is None:
            return self.__device_type
        return f"{self.__device_type}:{self.__device_id}"


cpu = Device("cpu")
"""The CPU (used only on request)."""

gpu = Device("gpu")
"""The process's current CUDA card: the default device."""

_default_device: Device = gpu


def get_device() -> Device:
    """The currently globally-set default device (reference devices.py:125)."""
    return _default_device


def sanitize_device(device: Optional[Union[str, Device, torch.device]]) -> Device:
    """Map a device specifier (None/str/Device/torch.device) onto a Device."""
    if device is None:
        return get_device()
    if isinstance(device, Device):
        return device
    if isinstance(device, torch.device):
        return Device("cpu") if device.type == "cpu" else Device("gpu", device.index)
    if isinstance(device, str):
        spec = device.strip().lower()
        if ":" in spec:
            dtype, _, did = spec.partition(":")
            return Device(dtype, int(did))
        return Device(spec)
    raise ValueError(f"Unknown device, must be str or Device, got {device!r}")


def use_device(device: Optional[Union[str, Device]] = None) -> None:
    """Set the globally-used default device; ``None`` restores the card
    (reference devices.py:157)."""
    global _default_device
    _default_device = gpu if device is None else sanitize_device(device)
