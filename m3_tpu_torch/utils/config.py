"""The port's one configuration error.

``m3_tpu/utils/config.py:23 ConfigError``: raised by an options object's
``validate()`` (``resident.pool.ResidentOptions``,
``index.device.store.IndexDeviceOptions``). The rest of that module (YAML
loading and env interpolation) waits for the services slice (ROADMAP §A10).
"""

from __future__ import annotations


class ConfigError(ValueError):
    """Invalid options."""
