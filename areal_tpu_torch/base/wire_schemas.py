"""Wire schema tags of the KV and weight planes and of the recovery
records (the port's copy of the entries of
``areal_tpu/base/wire_schemas.py`` it speaks). The strings are the
reference's byte for byte: a blob or manifest of either package is read
by the other."""

from __future__ import annotations

# Versioned KV-handoff blob (engine/kv_handoff.py): meta + typed array
# segments in one chunk-hashed payload.
KV_HANDOFF_V1 = "areal-kv-handoff/v1"

# Tiered-KV manifest: where a spilled or parked prefix lives (holder url
# and tier); the bytes inside stay KV_HANDOFF_V1 blobs.
KV_TIER_V1 = "areal-kv-tier/v1"

# Content-hashed weight chunk stream + manifest (base/chunking.py).
WEIGHT_CHUNKS_V1 = "areal-weight-chunks/v1"

# Trainer dump layout sidecar (system/weight_transfer.py).
WEIGHT_LAYOUT_V1 = "areal-weight-layout/v1"

# Trainer checkpoint manifest: the commit record written LAST (atomic
# rename) after every engine-state artifact landed, carrying the
# version, LR-schedule position, RNG state, and dataset cursors a
# resume needs (engine/checkpoint.py).
TRAIN_CKPT_V1 = "areal-train-ckpt/v1"

# Master recovery record: RecoverInfo pickle wrapper, including the
# consumed-sequence ledger persisted atomically with each checkpoint
# barrier (base/recover.py).
RECOVER_INFO_V1 = "areal-recover-info/v1"
