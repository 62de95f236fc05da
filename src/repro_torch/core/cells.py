"""Cell-family registry (counterpart of ``repro.core.cells``): the GRU and
the sLSTM.

A :class:`CellFamily` tells the executor (``repro_torch.core.runtime``)
how to normalize a family's parameter layouts, lay out its state and build
its fused kernels' weight views; backends register against a
``(family, backend)`` key. A stack's runtime state is a flat tuple of
per-layer leaves, layer-major, each (B, H): the GRU has one leaf per layer
(``h``), the sLSTM four (``c, n, m, h``: cell, normalizer, stabilizer,
hidden), so the executor's signatures, the engine's slot scatter and the
cache specs are the same for both.

Families register on import of their home module; :func:`ensure_families`
imports the in-tree ones, so a lookup never depends on import order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

__all__ = ["CellFamily", "UnknownCellFamily", "register_family",
           "get_family", "ensure_families", "families", "cfg_family",
           "is_cell_family"]


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

    ``gates``: gate columns per hidden unit (each layer's ``w`` is
    ``(X, gates*H)``, ``u`` ``(H, gates*H)``, ``b`` ``(gates*H,)``).
    ``state_leaves``/``state_names``/``h_leaf``: the flat per-layer state
    layout. ``init_state(cfg, batch, dtype, device)``: the flat initial
    state. ``normalize(params, cfg)``: any accepted parameter layout ->
    per-layer ``({"w","u","b"}, ...)``. ``stacked_views(cells)``: the
    fused kernels' weight stacks (None: the family has no fused backend).
    ``supports_quant``: whether ``prepare`` may build int8 weight views
    for this family. ``supports_placement``: whether it has mesh backends
    (``prepare`` builds placed views of a rank's part for it; a family
    without them runs replicated under a mesh)."""
    name: str
    gates: int
    state_leaves: int
    state_names: tuple
    h_leaf: int
    normalize: Callable = dataclasses.field(repr=False)
    init_state: Callable = dataclasses.field(repr=False)
    stacked_views: Optional[Callable] = dataclasses.field(repr=False,
                                                          default=None)
    supports_quant: bool = False
    supports_placement: bool = False


_FAMILIES: Dict[str, CellFamily] = {}


def register_family(family: CellFamily) -> None:
    _FAMILIES[family.name] = family


def ensure_families() -> None:
    """Import the in-tree families so registration never depends on import
    order."""
    if "slstm" not in _FAMILIES:
        from repro_torch.core import slstm  # noqa: F401 (registers on import)


def get_family(name: str) -> CellFamily:
    ensure_families()
    fam = _FAMILIES.get(name)
    if fam is None:
        raise UnknownCellFamily(name, known=_FAMILIES)
    return fam


def families() -> Dict[str, CellFamily]:
    """Snapshot of the registry (name -> family)."""
    ensure_families()
    return dict(_FAMILIES)


def is_cell_family(name: str) -> bool:
    """Whether ``name`` is a registered cell family (not an LM family)."""
    ensure_families()
    return name in _FAMILIES


def cfg_family(cfg) -> str:
    """The family a config compiles under (missing/empty -> "gru")."""
    return getattr(cfg, "family", "gru") or "gru"


def _gru_family() -> CellFamily:
    from repro_torch.core import gru as gru_core

    def stacked_views(cells):
        from repro_torch.kernels.gru_sequence import ops as seq_ops
        return seq_ops.prepare_stacked_cells(cells)

    return CellFamily(name="gru", gates=3, state_leaves=1,
                      state_names=("h",), h_leaf=0,
                      normalize=gru_core.stack_cell_params,
                      init_state=gru_core.stack_h0,
                      stacked_views=stacked_views, supports_quant=True,
                      supports_placement=True)


register_family(_gru_family())
