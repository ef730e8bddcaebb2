"""Physical data mapping of embedding rows onto NAND flash (paper Fig. 5).

Three layouts:

  baseline : rows stored in logical order; pages filled sequentially,
             blocks/pages striped across planes in row order (Fig. 5a).
  af       : access-frequency remap — rows sorted by frequency descending
             and packed into pages; pages fill plane 0 first, then plane 1,
             ... (Fig. 5b). Hot pages cluster in few planes.
  af_pd    : frequency-sorted pages are round-robined across planes so hot
             traffic hits every page buffer (plane distribution, Fig. 5c).

The mapping is the "hash table" of the paper: a dense array
``row -> (plane, page_in_plane, slot)`` plus the inverse permutation. The
physical *global* page id is ``plane * pages_per_plane + page_in_plane``;
the simulator only needs (plane, global_page).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.freq import AccessStats


@dataclasses.dataclass
class Mapping:
    """row -> physical placement for one table."""

    plane: np.ndarray        # (n_rows,) int32 plane id
    page: np.ndarray         # (n_rows,) int64 global page id (unique per page)
    slot: np.ndarray         # (n_rows,) int32 slot within page
    vec_bytes: int
    page_bytes: int
    n_planes: int
    mode: str
    perm: np.ndarray         # (n_rows,) hot-rank -> logical row (identity for baseline)

    @property
    def vectors_per_page(self) -> int:
        return self.page_bytes // self.vec_bytes

    @property
    def n_pages(self) -> int:
        return int(self.page.max()) + 1 if self.page.size else 0

    def lookup(self, rows: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorised physical address lookup for a batch of logical rows."""
        rows = np.asarray(rows)
        return self.plane[rows], self.page[rows], self.slot[rows]


def _place(order: np.ndarray, n_rows: int, vec_bytes: int, page_bytes: int,
           n_planes: int, distribute_planes: bool, mode: str) -> Mapping:
    vpp = max(1, page_bytes // vec_bytes)
    seq = np.arange(n_rows, dtype=np.int64)
    page_rank = seq // vpp                      # page index in fill order
    slot = (seq % vpp).astype(np.int32)
    n_pages = int(page_rank.max()) + 1 if n_rows else 0

    if distribute_planes:
        # round-robin pages across planes (PD)
        plane_of_page = (np.arange(n_pages, dtype=np.int64) % n_planes)
    else:
        # fill plane 0 completely, then plane 1, ... (AF w/o PD, Fig. 5b)
        pages_per_plane = -(-n_pages // n_planes)  # ceil
        plane_of_page = (np.arange(n_pages, dtype=np.int64) // max(1, pages_per_plane))
    plane_of_page = np.minimum(plane_of_page, n_planes - 1).astype(np.int32)

    plane = np.empty(n_rows, dtype=np.int32)
    page = np.empty(n_rows, dtype=np.int64)
    slot_arr = np.empty(n_rows, dtype=np.int32)
    # order[i] = logical row placed at fill-position i
    plane[order] = plane_of_page[page_rank]
    page[order] = page_rank
    slot_arr[order] = slot
    return Mapping(plane=plane, page=page, slot=slot_arr, vec_bytes=vec_bytes,
                   page_bytes=page_bytes, n_planes=n_planes, mode=mode,
                   perm=order)


def build_mapping_from_order(order: np.ndarray, vec_bytes: int,
                             page_bytes: int, n_planes: int,
                             mode: str = "af_pd") -> Mapping:
    """Build a Mapping from an explicit fill order (e.g. Algorithm-1 output).

    ``order[i]`` = logical row placed at physical fill-position ``i``. Used
    after an adaptive remap, where the hash table dictates the full order
    (hot region re-sorted, cold tail in arrival order).
    """
    order = np.asarray(order, dtype=np.int64)
    return _place(order, order.shape[0], vec_bytes, page_bytes, n_planes,
                  distribute_planes=(mode != "af"), mode=mode)


def build_mapping(n_rows: int, vec_bytes: int, page_bytes: int, n_planes: int,
                  mode: str = "baseline",
                  stats: AccessStats | None = None) -> Mapping:
    """Build the row -> flash placement for one embedding table."""
    if mode == "baseline":
        order = np.arange(n_rows, dtype=np.int64)
        # baseline stripes pages across planes in logical order (commodity
        # FTL behaviour) — scattered hot rows land on all planes anyway.
        return _place(order, n_rows, vec_bytes, page_bytes, n_planes,
                      distribute_planes=True, mode=mode)
    if stats is None:
        raise ValueError(f"mode={mode!r} needs AccessStats")
    order = stats.rank_order()
    if mode == "af":
        return _place(order, n_rows, vec_bytes, page_bytes, n_planes,
                      distribute_planes=False, mode=mode)
    if mode == "af_pd":
        return _place(order, n_rows, vec_bytes, page_bytes, n_planes,
                      distribute_planes=True, mode=mode)
    raise ValueError(f"unknown mapping mode {mode!r}")
