"""Config registry: one module per assigned architecture, and
``gust_paper``'s five accelerator specs (copied from ``repro.configs``)."""

from .base import ArchConfig, ShapeConfig, SHAPES, get_arch, list_archs, ARCH_IDS
