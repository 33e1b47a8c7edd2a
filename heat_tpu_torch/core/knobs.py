"""Public face of the ``HEAT_TPU_*`` knob registry.

Counterpart of ``heat_tpu/core/knobs.py``. The registry lives in
:mod:`heat_tpu_torch._knobs`, a stdlib-only leaf module, because
``heat_tpu_torch.telemetry`` and ``heat_tpu_torch.resilience`` read knobs
before ``heat_tpu_torch.core`` is imported. User code and core modules
import this module::

    from heat_tpu_torch.core import knobs
    knobs.get("HEAT_TPU_FUSION")            # typed read (overlay, then environment)
    knobs.raw("HEAT_TPU_FAULTS", "")        # raw string, registered-name-checked
    knobs.tunables()                        # name -> Knob with its Tunable
    with knobs.overlay({"HEAT_TPU_RELAYOUT_PLAN": "chunked"}):
        ...

Modules that load early use ``from heat_tpu_torch import _knobs as knobs``:
the same objects, without importing ``heat_tpu_torch.core``.
"""

from .._knobs import (  # noqa: F401
    FALSY,
    REGISTRY,
    TRUTHY,
    Knob,
    Tunable,
    clear_overrides,
    default_raw,
    get,
    markdown_table,
    names,
    overlay,
    overrides,
    raw,
    set_override,
    tunables,
)

__all__ = [
    "FALSY",
    "TRUTHY",
    "Knob",
    "REGISTRY",
    "Tunable",
    "clear_overrides",
    "default_raw",
    "get",
    "markdown_table",
    "names",
    "overlay",
    "overrides",
    "raw",
    "set_override",
    "tunables",
]
