"""The release vocabulary shared by the host arena and the device pool.

The JAX package's ``core/vm.py`` also holds the mmap arena of the paper's
§3.2 (``madvise`` / shared-remap release, ``mincore`` residency).  The port
serves from the device page pool, which needs only the two names below:
``ReleaseStrategy`` (what a released superblock means) and
``superblock_floor`` (how many superblocks a release must keep mapped).
"""

from __future__ import annotations

import enum


class ReleaseStrategy(enum.Enum):
    """How released superblocks relate to the OS (paper §3.1–§3.2).

    Shared vocabulary between the host arena and the device page pool
    (``core.pagepool`` / the serving engine): ``KEEP`` recycles within the
    process but never releases; ``MADVISE`` / ``SHARED_REMAP`` release
    physical frames while the virtual range stays readable.
    """

    KEEP = "keep"
    MADVISE = "madvise"
    SHARED_REMAP = "shared_remap"


def superblock_floor(distinct_live_pages: int, pages_per_superblock: int,
                     min_mapped: int = 1) -> int:
    """Mapped-superblock floor a release must respect, given demand.

    ``distinct_live_pages`` must count every page ONCE no matter how many
    holders reference it (a shared prefix page backs several requests and
    the prefix cache at once).  Returns
    ``max(min_mapped, ceil(pages / pages_per_superblock))``.
    """
    if pages_per_superblock <= 0:
        raise ValueError("pages_per_superblock must be positive")
    need = -(-max(0, distinct_live_pages) // pages_per_superblock)
    return max(min_mapped, need)
