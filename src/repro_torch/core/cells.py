"""Cell-family registry (counterpart of ``repro.core.cells``), GRU family
only; sLSTM comes in a later slice.

A :class:`CellFamily` tells the executor (``repro_torch.core.runtime``)
how to normalize a family's parameter layouts and build its fused kernels'
weight views; backends register against a ``(family, backend)`` key. A
stack's runtime state is a flat tuple of per-layer leaves, each (B, H);
GRU has one leaf per layer (``h``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

__all__ = ["CellFamily", "UnknownCellFamily", "register_family",
           "get_family", "cfg_family"]


class UnknownCellFamily(KeyError):
    """``cfg.family`` names no registered cell family."""

    def __init__(self, name: str, known=()):
        super().__init__(name)
        self.family = name
        self.known = tuple(sorted(known))

    def __str__(self) -> str:
        return (f"unknown cell family {self.family!r}; registered families: "
                f"{list(self.known)}")


@dataclasses.dataclass(frozen=True)
class CellFamily:
    """One recurrence family, as the executor sees it.

    ``normalize(params, cfg)``: any accepted parameter layout -> per-layer
    ``({"w","u","b"}, ...)``. ``stacked_views(cells)``: the fused kernels'
    weight stacks (None: the family has no fused backend)."""
    name: str
    normalize: Callable = dataclasses.field(repr=False)
    stacked_views: Optional[Callable] = dataclasses.field(repr=False,
                                                          default=None)


_FAMILIES: Dict[str, CellFamily] = {}


def register_family(family: CellFamily) -> None:
    _FAMILIES[family.name] = family


def get_family(name: str) -> CellFamily:
    fam = _FAMILIES.get(name)
    if fam is None:
        raise UnknownCellFamily(name, known=_FAMILIES)
    return fam


def cfg_family(cfg) -> str:
    """The family a config compiles under (missing/empty -> "gru")."""
    return getattr(cfg, "family", "gru") or "gru"


def _gru_family() -> CellFamily:
    from repro_torch.core import gru as gru_core

    def stacked_views(cells):
        from repro_torch.kernels.gru_sequence import ops as seq_ops
        return seq_ops.prepare_stacked_cells(cells)

    return CellFamily(name="gru", normalize=gru_core.stack_cell_params,
                      stacked_views=stacked_views)


register_family(_gru_family())
