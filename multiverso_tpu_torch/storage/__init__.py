"""Tiered KV storage: KV tables across device memory, pinned host RAM and
disk.

Counterpart of ``multiverso_tpu/storage/``: put each bucket where it
fits, move only what the step touches. See ``tiered_kv.py`` for the
table, ``manager.py`` for the placement policy and ``tiers.py`` for the
host arena and the CRC-stamped disk spill file.
"""

from multiverso_tpu_torch.storage.manager import (TIER_DEVICE, TIER_DISK,
                                                  TIER_HOST, TIER_VIRGIN,
                                                  TierConfig, TierManager,
                                                  status_all)
from multiverso_tpu_torch.storage.tiered_kv import TieredKVTable
from multiverso_tpu_torch.storage.tiers import (BucketRecord, DiskTier,
                                                HostTier, RecordSpec)

__all__ = [
    "BucketRecord", "DiskTier", "HostTier", "RecordSpec",
    "TIER_DEVICE", "TIER_DISK", "TIER_HOST", "TIER_VIRGIN",
    "TierConfig", "TierManager", "TieredKVTable", "status_all",
]
