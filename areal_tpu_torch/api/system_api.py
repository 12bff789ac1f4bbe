"""Worker configuration (the port's copy of ``GenerationServerConfig``
from ``areal_tpu/api/system_api.py``: the reference's fields and
defaults, plus ``device``). The generation server refuses at boot every
field of a feature the port lacks when it is set to anything but its
default (``system/generation_server.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from areal_tpu_torch.api.config import ModelAbstraction


@dataclasses.dataclass
class GenerationServerConfig:
    experiment_name: str = ""
    trial_name: str = ""
    server_index: int = 0
    # Which registered model family this server hosts (multi-model
    # serving plane, system/model_registry.py). Stamped into the
    # heartbeat payload so the manager pools the fleet per model; a
    # mismatch is a routing error, never a silent cross-model KV or
    # weight hit. None = the manager's default model_name (the
    # single-model fleets every pre-registry deployment runs).
    model_id: Optional[str] = None
    model_path: Optional[str] = None
    model: ModelAbstraction = None
    tokenizer_path: Optional[str] = None
    max_concurrent_requests: int = 64
    max_seq_len: int = 2048
    kv_page_size: int = 128
    # Token capacity of the paged KV pool (None -> B * max_seq_len, i.e.
    # no memory pressure). Sizing it below that serves long contexts in
    # bounded HBM with preempt-and-resubmit under pressure.
    kv_pool_tokens: Optional[int] = None
    decode_block_steps: int = 16
    # Prompts pad up to a multiple of this (bounds compiled prefill
    # shapes); prefill_max_batch caps prompts per batched prefill.
    prompt_bucket: int = 64
    prefill_max_batch: int = 8
    # Prompts longer than this prefill chunk-by-chunk through one
    # fixed-shape program (None disables; essential for 16-32k prompts
    # where each new length bucket is a fresh multi-second compile).
    prefill_chunk: Optional[int] = None
    # Chunked / cache-hit prefills run one prompt at a time on the serve
    # loop; this caps how many are admitted per lap so decode latency
    # jitter for running slots stays bounded.
    chunked_prefill_per_lap: int = 2
    # qid-keyed prefix KV reuse budget in tokens (None disables): a
    # resubmission extending a parked sequence prefills only the delta —
    # the radix-cache role for partial-rollout chunking.
    prefix_cache_tokens: Optional[int] = None
    # KV pool precision: None/"model" stores the compute dtype; "int8"
    # stores quantized (data, scales) pages — half the decode HBM
    # traffic, double the tokens per pool budget (engine/paged.py).
    kv_cache_dtype: Optional[str] = None
    # N-gram (prompt-lookup) speculative decoding: >0 drafts that many
    # tokens per decode step and keeps the verified prefix — lossless,
    # device-resident (engine/spec_decode.py). 0 disables.
    speculative_draft_len: int = 0
    speculative_ngram: int = 2
    # Backward search window (tokens) for the draft lookup; bounds the
    # per-step match cost at long contexts. None = engine default (1024);
    # 0 = unbounded full-history scan.
    speculative_window: Optional[int] = None
    # int8 DECODE weights (W8A16, ops/wquant.py): halves the per-step
    # weight stream; prefill stays bf16. None/"model" disables.
    decode_weight_dtype: Optional[str] = None
    # Token-budget continuous batching: per-admission-round cap on
    # UNCACHED prefill tokens (None = unbounded). Bounds how much
    # prefill work interleaves into one scheduler iteration — the
    # TTFT-vs-ITL knob under load (engine/serving.py, docs/serving.md).
    prefill_token_budget: Optional[int] = None
    # Prefill/decode interleave ratio: decode blocks run between
    # admission rounds (1 = admit every block boundary).
    decode_blocks_per_admit: int = 1
    # Bounded admission queue (backpressure): beyond either watermark,
    # /generate sheds with 429 + Retry-After instead of queueing
    # unboundedly — the open-loop tail-latency guarantee. None disables.
    max_queue_depth: Optional[int] = None
    max_queued_tokens: Optional[int] = None
    # Retry-After hint handed to shed clients (partial_rollout backs off
    # with jitter around it; the manager routes around the server for
    # this long).
    shed_retry_after_s: float = 1.0
    # Disaggregated prefill/decode serving (docs/serving.md): the
    # server's starting pool role. "prefill" servers take fresh prompts,
    # run chunked prefill to the first token, and hand the KV off to a
    # decode server; "decode" servers import handoff blobs and run the
    # decode stream; "unified" serves both (legacy) and is the manager's
    # elastic re-role pool — /set_role flips the live role at runtime
    # (drain + flip; weights stay resident). Any role still serves plain
    # /generate: the handoff path only engages when the manager pairs a
    # decode server into the request.
    role: str = "unified"
    # int8-compress exported KV handoff blobs (halves the
    # server-to-server hop; the importer dequantizes). None ships the
    # pool's own precision.
    kv_handoff_compress: Optional[str] = None
    # Tiered KV plane (engine/kv_tier.py, docs/serving.md): host-RAM
    # capacity for spilled prefixes. Prefix-cache evictions spill here
    # (handoff wire format) instead of being freed; returning sessions
    # restore instead of re-prefilling, and peers can pull held
    # prefixes over /kv/{manifest,chunk}. None = AREAL_KV_TIER_BYTES
    # (default 0 = disabled).
    kv_tier_bytes: Optional[int] = None
    # Optional local-disk second tier: host-LRU evictions demote here
    # (hash-verified on read-back). None = AREAL_KV_TIER_DISK_DIR.
    kv_tier_disk_dir: Optional[str] = None
    kv_tier_disk_bytes: Optional[int] = None
    # Spill wire precision: 'int8' quantizes FLOAT pools' prefixes on
    # the spill wire (halves tier bytes; int8 pools always spill their
    # (data, scales) form). None = AREAL_KV_SPILL_DTYPE.
    kv_spill_dtype: Optional[str] = None
    # Shard the engine over this many local devices (megatron-style TP
    # via GSPMD; see engine/serving.serving_mesh).
    tensor_parallel: int = 1
    # Shard-aware weight plane (docs/weight_updates.md): this server's
    # coordinates in a FLEET-level tensor-parallel group. When set, the
    # server fetches only its slice of each weight version (a sliced
    # shard manifest — per-server ingress and host staging drop by
    # ~degree; same-shard peers fan chunks to each other) and cutover
    # device_puts the shard slabs directly under the engine's
    # NamedSharding. Both set or both None; requires a multi-host-style
    # deployment where this process hosts exactly the mesh slice for
    # weight_shard_rank (the manager groups fanout trees by shard).
    weight_shard_rank: Optional[int] = None
    weight_shard_degree: Optional[int] = None
    # Pre-compile the serving programs (prefill bucket + decode block,
    # ServingEngine.warm) BEFORE the server registers for discovery:
    # the first real rollout request then never eats a multi-second XLA
    # compile. Costs startup latency; pays off whenever a persistent
    # compilation cache is configured.
    warm_on_start: bool = False
    # Drain-then-leave (POST /drain): upper bound on waiting for
    # in-flight requests to finish before the parked-prefix migration
    # starts (admission is already shedding by then).
    drain_wait_s: float = 60.0
    seed: int = 1
    # The port's one field beyond the reference's: the torch device the
    # engine runs on. The CPU runs the kernels' plain versions (tests).
    device: str = "cuda"

    @property
    def worker_name(self) -> str:
        return f"generation_server/{self.server_index}"
