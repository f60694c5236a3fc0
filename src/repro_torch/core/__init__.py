"""Lattices and dense CRDT types (PyTorch)."""

from repro_torch.core.lattice import Lattice, MapLattice
from repro_torch.core.types import BitGSet, GCounter, GMap, GSet, popcount32
from repro_torch.core.value_lattices import ValueLattice, max_int, or_bool

__all__ = ["BitGSet", "GCounter", "GMap", "GSet", "Lattice", "MapLattice",
           "ValueLattice", "max_int", "or_bool", "popcount32"]
