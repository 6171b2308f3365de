"""Paper core: the CYCLIC and GENERAL hash families, GF(2) set-up arithmetic,
uint32 lane helpers and the MinHash sketch."""
from repro_torch.core.families import (
    FAMILIES,
    Cyclic,
    General,
    init_h1,
    make_family,
)
from repro_torch.core.sketches import MinHash

__all__ = ["FAMILIES", "Cyclic", "General", "init_h1", "make_family",
           "MinHash"]
