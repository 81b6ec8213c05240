# Copied from gnss_sdr_tpu/config/__init__.py; only the package imports are rewritten.
"""Configuration system (reference: src/core/receiver/{file,in_memory}_configuration.*)."""

from gnss_sdr_tpu_torch.config.configuration import (
    ConfigurationInterface,
    FileConfiguration,
    InMemoryConfiguration,
)

__all__ = ["ConfigurationInterface", "FileConfiguration", "InMemoryConfiguration"]
