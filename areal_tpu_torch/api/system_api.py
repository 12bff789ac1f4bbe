"""Worker configuration (the port's copy of ``ModelShardSpec``,
``ModelWorkerConfig``, ``ExperimentSaveEvalControl``,
``MasterWorkerConfig``, ``GenerationServerConfig``,
``GserverManagerConfig``, ``RolloutWorkerConfig`` and
``ExperimentConfig`` from ``areal_tpu/api/system_api.py``: the
reference's fields and defaults, plus ``device`` on the model worker and
the generation server). A worker refuses at boot every field of a
feature the port lacks when it is set to anything but its default
(``system/model_worker.py``, ``system/generation_server.py``,
``system/gserver_manager.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from areal_tpu_torch.api.config import (
    AgentAbstraction,
    DatasetAbstraction,
    EnvServiceAbstraction,
    ModelAbstraction,
    ModelBackendAbstraction,
    ModelInterfaceAbstraction,
    ModelShardID,
)
from areal_tpu_torch.api.dfg import MFCDef
from areal_tpu_torch.api.model_api import GenerationHyperparameters


@dataclasses.dataclass
class ModelShardSpec:
    """One model hosted on a model worker: how to build and wrap it."""

    id: ModelShardID
    model: ModelAbstraction = None
    backend: ModelBackendAbstraction = None
    interface: ModelInterfaceAbstraction = None
    eval_dataset: Optional[DatasetAbstraction] = None
    # initial HF checkpoint path (None = random init from model args)
    model_path: Optional[str] = None


@dataclasses.dataclass
class ModelWorkerConfig:
    experiment_name: str = ""
    trial_name: str = ""
    worker_index: int = 0
    shards: List[ModelShardSpec] = dataclasses.field(default_factory=list)
    # Dataset hosting (only on workers that serve the src MFC's model):
    datasets: List[DatasetAbstraction] = dataclasses.field(default_factory=list)
    tokenizer_path: Optional[str] = None
    use_dataset_cache: bool = False
    # dp coordinates for dataset sharding
    dataset_dp_rank: int = 0
    dataset_dp_size: int = 1
    train_batch_size: int = 8
    total_train_epochs: int = 1
    seed: int = 1
    # async mode: pull trajectories from rollout workers instead of a dataset
    stream_dataset: bool = False
    n_pullers: int = 1
    shuffle_dataset: bool = True
    # Multi-host sharded training (one train partition over several hosts).
    train_n_hosts: int = 1
    train_host_rank: int = 0
    # Streaming weight-distribution plane and its wire.
    weight_plane: bool = False
    weight_chunk_bytes: int = 8 << 20
    weight_wire_dtype: Optional[str] = None
    # The port's one field beyond the reference's: the torch device the
    # worker's engines run on. The CPU runs the kernels' plain versions.
    device: str = "cuda"

    @property
    def worker_name(self) -> str:
        return f"model_worker/{self.worker_index}"


@dataclasses.dataclass
class ExperimentSaveEvalControl:
    # None = inherit the experiment's top-level total_train_epochs.
    total_train_epochs: Optional[int] = None
    # Exactly one of *_freq_{epochs,steps,secs} may be set per action.
    save_freq_epochs: Optional[int] = None
    save_freq_steps: Optional[int] = None
    save_freq_secs: Optional[int] = None
    ckpt_freq_epochs: Optional[int] = None
    ckpt_freq_steps: Optional[int] = None
    ckpt_freq_secs: Optional[int] = None
    eval_freq_epochs: Optional[int] = None
    eval_freq_steps: Optional[int] = None
    eval_freq_secs: Optional[int] = None
    benchmark_steps: Optional[int] = None  # stop early after N steps


@dataclasses.dataclass
class MasterWorkerConfig:
    experiment_name: str = ""
    trial_name: str = ""
    exp_ctrl: ExperimentSaveEvalControl = dataclasses.field(
        default_factory=ExperimentSaveEvalControl
    )
    rpcs: List[MFCDef] = dataclasses.field(default_factory=list)
    # model_name(str) -> list of model-worker names hosting it (DP order)
    model_topos: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    # worker names hosting the dataset ("fetch" targets, DP order)
    data_hosts: List[str] = dataclasses.field(default_factory=list)
    n_model_workers: int = 1
    train_batch_size: int = 8
    dataset_size: int = 0
    buffer_max_size: int = 16384
    recover_mode: str = "disabled"  # disabled | auto | resume

    @property
    def worker_name(self) -> str:
        return "master"


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


@dataclasses.dataclass
class GserverManagerConfig:
    experiment_name: str = ""
    trial_name: str = ""
    model_name: str = "actor"
    n_servers: int = 1
    schedule_policy: str = "round_robin"  # | least_requests | least_token_usage
    # Prefix-/session-affinity routing: a rollout's next chunk/turn is
    # routed to the server holding its KV prefix (affinity map keyed by
    # the request qid, surviving weight-version bumps), with load-aware
    # spill to the least-loaded server when the target is saturated or
    # shedding. Applies on top of schedule_policy (which places the
    # FIRST chunk of each session).
    session_affinity: bool = True
    # Spill threshold: an affinity target with at least this many
    # estimated in-flight requests is considered saturated and the
    # session spills. None = spill only on shed/unhealthy.
    affinity_saturation_requests: Optional[int] = None
    # LRU cap on the affinity map (entries are one url per qid).
    affinity_map_size: int = 65536
    # Global prefix index (tiered KV plane, docs/serving.md): LRU cap
    # on the qid -> (holder, tier) map fed from each server's
    # /kv/index. Affinity is the fast path; this index lets ANY server
    # serve a returning session by pulling its prefix from whichever
    # peer/tier holds it. None = AREAL_KV_INDEX_SIZE (default 65536);
    # 0 disables index-aware routing.
    kv_index_size: Optional[int] = None
    max_head_offpolicyness: int = 0
    train_batch_size: int = 8
    flush_request_timeout: float = 120.0
    max_concurrent_rollouts: Optional[int] = None
    # Cadence of the health-registry fold (eviction of dead servers,
    # re-sync + readmission of returning ones). Chaos tests shrink it
    # together with AREAL_HEALTH_TTL for sub-second failover.
    health_check_interval: float = 2.0
    # Streaming weight-distribution plane (system/weight_plane.py): when
    # True, weight updates fan out over a peer tree (origin uploads each
    # byte once; holders serve siblings) instead of every server
    # re-reading the full checkpoint from NFS. The origin is the
    # trainer-side source registered in name_resolve, falling back to a
    # manager-hosted source over the NFS dump dir.
    weight_plane: bool = False
    # Chunk size for the manager-hosted origin (a trainer-side source
    # uses its own); per-chunk hashed, Range-resumable.
    weight_chunk_bytes: int = 8 << 20
    # Quantized weight wire for plane fanouts: "int8" fetches/ships the
    # dump's quantized companion stream (~half the bytes per version;
    # servers dequantize at assembly). Requires the dump side to arm
    # ModelWorkerConfig.weight_wire_dtype with the same value. None
    # ships raw bytes.
    weight_wire_dtype: Optional[str] = None
    # Children per node in the fanout tree: origin egress is bounded by
    # degree * payload; deeper trees trade origin egress for extra hops.
    weight_fanout_degree: int = 2
    # Target bound for the serve-interrupting cutover window (interrupt
    # + device swap), measured separately from transfer. Overruns are
    # surfaced (within_budget=false + warning), not fatal.
    weight_cutover_budget_s: float = 3.0
    # Elastic prefill/decode pool sizing (docs/serving.md): when True
    # the manager re-roles servers whose CONFIGURED role is "unified"
    # between the prefill and decode pools from queue-depth/free-page
    # watermarks. Re-role is drain + flip — the manager stops routing
    # new work of the old kind first, in-flight requests finish, weights
    # stay resident.
    elastic_pools: bool = False
    # Minimum seconds between re-role decisions (flapping guard).
    rerole_cooldown_s: float = 10.0
    # Queued-prompt-token watermarks over the prefill-capable pool: at
    # or above `high` an elastic decode-side server flips to prefill; at
    # or below `low` a server this manager flipped to prefill flips
    # back.
    prefill_queue_high_tokens: int = 4096
    prefill_queue_low_tokens: int = 0
    # Decode-pool free-page floor: below this fraction an elastic
    # prefill-side server flips to decode (and blocks further
    # prefill-ward flips).
    decode_free_page_min_frac: float = 0.1
    # Each pool keeps at least this many servers through re-roles.
    pool_min_prefill: int = 1
    pool_min_decode: int = 1
    # ---- Elastic fleet control plane (system/fleet_controller.py,
    # docs/fault_tolerance.md "Fleet elasticity + manager HA") --------
    # Runtime join/leave + manager HA: unknown heartbeating servers are
    # ADOPTED (weight-bootstrapped from peers before routing), graceful
    # departures are forgotten cleanly, and the manager persists an
    # epoch/weight-version lease so a restart rebuilds everything else
    # from heartbeats + /metrics. False = fixed fleet, no lease. The
    # port's manager runs a fixed fleet, so its default is False (the
    # reference's is True) and True is refused.
    elastic_fleet: bool = False
    # Warm standby: block in configure until the current lease holder's
    # record expires, then take over (instead of failing after 300 s).
    standby: bool = False
    # Joiner weight source: "peers" fetches chunk streams from
    # same-shard holders (origin last resort, never NFS); "origin"
    # forces the plane origin (the bench's baseline arm).
    join_bootstrap: str = "peers"
    # A drain that hasn't completed (graceful departure observed) by
    # this deadline is EVICTED while it finishes quiescing — a drain
    # cannot be cancelled server-side, so the server could never take
    # traffic again; its graceful stop (or death) stays the terminal
    # transition.
    drain_timeout_s: float = 120.0
    # Watermark autoscaling (fleet_controller.WatermarkAutoscaler):
    # scale-out/in decisions from the SAME queued-token / free-page
    # signals the re-role sizer polls, actuated through a launcher
    # attached via GserverManager.attach_launcher. Off by default —
    # policy without actuation only logs a warning.
    autoscale: bool = False
    # Fleet-average queued prompt tokens per routable server at/above
    # which the fleet grows; at/below scale_in the least-loaded server
    # is drained (only while free pages are comfortable).
    scale_out_queued_tokens: int = 4096
    scale_in_queued_tokens: int = 64
    scale_free_page_min_frac: float = 0.5
    pool_min_servers: int = 1
    pool_max_servers: int = 8
    scale_cooldown_s: float = 15.0
    # Consecutive over/under-watermark metrics polls before acting.
    scale_sustain_polls: int = 2
    # ---- Multi-model serving plane (system/model_registry.py) -------
    # When True the manager partitions the fleet into per-model pools
    # from registry records + heartbeat model_ids: routing, affinity,
    # the KV prefix index, shed/breaker candidacy, and the autoscaler
    # all become model-scoped, and each registered model's weight
    # version is watched (and fanned out) independently. Heartbeats
    # naming an UNREGISTERED model_id are quarantined instead of
    # adopted. False = the legacy single-model fleet: every server is
    # assumed to host `model_name` and extra model_version keys are
    # ignored.
    multi_model: bool = False

    @property
    def worker_name(self) -> str:
        return "gserver_manager"


@dataclasses.dataclass
class RolloutWorkerConfig:
    experiment_name: str = ""
    trial_name: str = ""
    worker_index: int = 0
    n_rollout_workers: int = 1
    n_pullers: int = 1
    model_name: str = "actor"
    agent: AgentAbstraction = None
    env: EnvServiceAbstraction = None
    datasets: List[DatasetAbstraction] = dataclasses.field(default_factory=list)
    tokenizer_path: Optional[str] = None
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters
    )
    new_tokens_per_chunk: int = 1 << 30  # chunked interruptible generation
    max_concurrent_rollouts: int = 32
    rollout_request_timeout: float = 300.0
    # Per-sample failover budget: dead-server resubmissions + no-healthy-
    # server backoff rounds before the episode errors (and is dropped).
    rollout_max_retries: int = 8
    seed: int = 1

    @property
    def worker_name(self) -> str:
        return f"rollout_worker/{self.worker_index}"


@dataclasses.dataclass
class ExperimentConfig:
    """Everything the controller needs to launch one trial."""

    experiment_name: str = ""
    trial_name: str = ""
    master: MasterWorkerConfig = None
    model_workers: List[ModelWorkerConfig] = dataclasses.field(default_factory=list)
    rollout_workers: List[RolloutWorkerConfig] = dataclasses.field(default_factory=list)
    gserver_manager: Optional[GserverManagerConfig] = None
    generation_servers: List[GenerationServerConfig] = dataclasses.field(
        default_factory=list
    )
