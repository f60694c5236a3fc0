"""Lattices, their constructions and the CRDT types (PyTorch)."""

from repro_torch.core import value_lattices
from repro_torch.core.lattice import (BatchWeights, Lattice, MapLattice,
                                      align_weights, decompose_dense,
                                      join_all, leq_from_join, linear_sum,
                                      product, tree_leaves, tree_map)
from repro_torch.core.types import (BitGSet, GCounter, GMap, GSet,
                                    LexCounter, LWWMap, PNCounter,
                                    popcount32)
from repro_torch.core.value_lattices import (ValueLattice, lex_pair,
                                             max_int, or_bool)

__all__ = ["BatchWeights", "BitGSet", "GCounter", "GMap", "GSet", "Lattice", "LexCounter",
           "LWWMap", "MapLattice", "PNCounter", "ValueLattice",
           "align_weights", "decompose_dense", "join_all", "leq_from_join", "lex_pair",
           "linear_sum", "max_int", "or_bool", "popcount32", "product",
           "tree_leaves", "tree_map", "value_lattices"]
