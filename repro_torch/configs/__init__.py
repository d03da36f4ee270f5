"""Config registry: one module per assigned architecture (copied from
``repro.configs``; ``gust_paper`` waits for ``core/hardware_model``)."""

from .base import ArchConfig, ShapeConfig, SHAPES, get_arch, list_archs, ARCH_IDS
