"""Typed pipeline configuration tree + launch-file presets."""

from .presets import PRESETS, PipelineConfig, get_preset

__all__ = ["PRESETS", "PipelineConfig", "get_preset"]
