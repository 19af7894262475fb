"""Scheduler-side offload manager (runs on mesh-rank 0 only).

Decides what to load/store against shared storage by probing the file
layout — stateless, like the reference manager (kv_connectors/
llmd_fs_backend/llmd_fs_backend/manager.py:44-103): lookup counts
consecutive resident blocks from the start; stores are always accepted
(shared storage does its own eviction); loads need no preparation.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

from llm_d_kv_cache_manager_tpu_torch.offload.file_mapper import FileMapper


@dataclass
class PrepareStoreOutput:
    block_hashes_to_store: List[int]
    block_hashes_evicted: List[int] = field(default_factory=list)


class SharedStorageOffloadManager:
    def __init__(
        self, file_mapper: FileMapper, full_file_nbytes: Optional[int] = None
    ) -> None:
        self.file_mapper = file_mapper
        # Bytes of a full block-group file.  When known, lookup demands
        # it: a smaller file is a partial (head) group whose tail blocks
        # are not resident, and promising it to the scheduler would make
        # the later load fail after the placement decision.
        self.full_file_nbytes = full_file_nbytes

    def lookup(self, block_hashes: Iterable[int]) -> int:
        """Consecutive-from-start resident block count."""
        hits = 0
        for block_hash in block_hashes:
            path = self.file_mapper.get_file_name(block_hash)
            try:
                size = os.path.getsize(path)
            except OSError:
                break
            if self.full_file_nbytes is not None and size < self.full_file_nbytes:
                break
            hits += 1
        return hits

    def prepare_load(self, block_hashes: Iterable[int]) -> List[int]:
        return list(block_hashes)

    def complete_load(self, block_hashes: Iterable[int]) -> None:
        pass

    def touch(self, block_hashes: Iterable[int]) -> None:
        """Refresh mtime so recency sweepers keep hot blocks.

        Load-heavy fleets never re-store a popular prefix, and reads
        don't move mtime (atime is dead on noatime mounts), so without
        this the hottest blocks look coldest.  Best-effort: a vanished
        file is simply skipped.
        """
        for block_hash in block_hashes:
            try:
                os.utime(self.file_mapper.get_file_name(block_hash))
            except OSError:
                pass

    def prepare_store(
        self, block_hashes: Iterable[int]
    ) -> Optional[PrepareStoreOutput]:
        return PrepareStoreOutput(block_hashes_to_store=list(block_hashes))

    def complete_store(
        self, block_hashes: Iterable[int], success: bool = True
    ) -> None:
        pass
