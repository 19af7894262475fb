"""Block-hash -> shared-storage path mapping.

Layout parity with the reference connector (kv_connectors/llmd_fs_backend/
llmd_fs_backend/file_mapper.py:40-88) so fleets can mix GPU and TPU pods on
one shared filesystem:

    <root>/<model>
          /block_size_<device_block_size>_blocks_per_file_<blocks_per_file>
          /tp_<tp>_pp_size_<pp>_pcp_size_<pcp>
          /rank_<rank>
          /<dtype>
          /<hhh>/<hh>/<hash16>.bin

The tp/pp/pcp axes come from the device mesh shape: each mesh-rank
offloads only its own KV shard, and a pod with the same mesh layout can
load any other pod's shards rank-for-rank.  The PyTorch port writes the
same paths, letter for letter, as the JAX package, so GPU and TPU pods
share one tree.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

_MASK64 = 0xFFFFFFFFFFFFFFFF


@dataclass(frozen=True)
class FileMapper:
    root_dir: str
    model_name: str
    device_block_size: int
    blocks_per_file: int
    tp_size: int = 1
    pp_size: int = 1
    pcp_size: int = 1
    rank: int = 0
    dtype: str = "bfloat16"

    @property
    def base_path(self) -> str:
        return os.path.join(
            self.root_dir,
            self.model_name,
            f"block_size_{self.device_block_size}"
            f"_blocks_per_file_{self.blocks_per_file}",
            f"tp_{self.tp_size}_pp_size_{self.pp_size}"
            f"_pcp_size_{self.pcp_size}",
            f"rank_{self.rank}",
            self.dtype,
        )

    def get_file_name(self, block_hash) -> str:
        """Path for one offloaded block; hash-prefix subdirs bound the
        per-directory fan-out."""
        if isinstance(block_hash, (bytes, bytearray)):
            block_hash = int.from_bytes(block_hash, "little")
        hash_hex = f"{block_hash & _MASK64:016x}"
        return os.path.join(
            self.base_path,
            hash_hex[:3],
            hash_hex[3:5],
            f"{hash_hex}.bin",
        )
