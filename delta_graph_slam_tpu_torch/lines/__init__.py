"""lines (PyTorch port): the line-feature scan matcher's configuration."""

from .align import LineScanmatcherConfig

__all__ = ["LineScanmatcherConfig"]
