"""Version information for heat_tpu_torch (the layout of
``heat_tpu/core/version.py``; the port is versioned on its own)."""

major: int = 0
"""Major version number."""
minor: int = 1
"""Minor version number."""
micro: int = 0
"""Micro version number."""
extension: str = None
"""Version extension tag (e.g. dev, rc)."""

if not extension:
    version: str = f"{major}.{minor}.{micro}"
else:
    version: str = f"{major}.{minor}.{micro}-{extension}"
