"""LRMalloc-style size classes.

LRMalloc serves every allocation up to 16KiB from a size class; larger
requests bypass the heap and map their own superblock (paper §4).  The table
below mirrors jemalloc-style spacing (multiples of 16 up to 128, then four
sub-steps per power of two), which is what LRMalloc uses.
"""

from __future__ import annotations

MAX_SZ: int = 16 * 1024  # largest size-class allocation (16KiB, paper §4)
MIN_SZ: int = 16


def _build_table() -> list[int]:
    sizes = [16 * i for i in range(1, 9)]  # 16..128 step 16
    lo = 128
    while sizes[-1] < MAX_SZ:
        step = lo // 4
        for k in range(1, 5):
            s = lo + k * step
            if s > MAX_SZ:
                break
            sizes.append(s)
        lo *= 2
    return sizes


SIZE_CLASSES: tuple[int, ...] = tuple(_build_table())
NUM_CLASSES: int = len(SIZE_CLASSES)

# Dense lookup: requested size (rounded up to 16) -> class index.
_LUT: list[int] = []


def _build_lut() -> None:
    ci = 0
    for sz16 in range(0, MAX_SZ + 1, 16):
        while SIZE_CLASSES[ci] < sz16:
            ci += 1
        _LUT.append(ci)


_build_lut()


def size_to_class(nbytes: int) -> int:
    """Size-class index serving ``nbytes``.  Raises for large allocations."""
    if nbytes > MAX_SZ:
        raise ValueError(f"{nbytes} exceeds the largest size class {MAX_SZ}")
    if nbytes < 1:
        nbytes = 1
    return _LUT[(nbytes + 15) // 16]


def class_block_size(ci: int) -> int:
    """Block size in bytes of size class ``ci``."""
    return SIZE_CLASSES[ci]
