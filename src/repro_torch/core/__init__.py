"""Paper core: the five hash families (THREEWISE, ID37, GENERAL,
BUFFERED-GENERAL, CYCLIC), GF(2) arithmetic, uint32 lane helpers, the
sketches, and the exact independence checkers (``core.independence``)."""
from repro_torch.core.families import (
    FAMILIES,
    ID37,
    BufferedGeneral,
    Cyclic,
    General,
    ThreeWise,
    init_h1,
    make_family,
)
from repro_torch.core.sketches import (
    BloomFilter,
    CountMinSketch,
    HyperLogLog,
    MinHash,
    trailing_zeros,
)

__all__ = ["FAMILIES", "ThreeWise", "ID37", "General", "BufferedGeneral",
           "Cyclic", "init_h1", "make_family",
           "BloomFilter", "CountMinSketch", "HyperLogLog", "MinHash",
           "trailing_zeros"]
