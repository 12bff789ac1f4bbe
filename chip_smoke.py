#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (areal_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out report.json] [--profile-serving] [--w8a16-sweep]
        [--fleet-worker-restarts N] [--serial] [--budget-s S]
        [--phases build,parity,serve_bf16,serve_int8,interrupt,spec,http,grad,train,workers,
                  async_ppo,sync_ppo,disagg,weight_plane,plane_loop,sft,recover,agentic,fleet]

Phases (every one must pass; the script exits nonzero on the first that
fails, and on a machine without CUDA). They run in the order below, but
for the side lane: where workers, async_ppo, sync_ppo or sft is run,
recover, agentic and plane_loop run in a second process
(``chip_smoke.py --serial``) beside them, and its report joins this
one's before disagg (--serial: everything here, in order, sft after
sync_ppo). Past --budget-s (RUN_BUDGET_S, 1150 s) the run stops every
process it started and exits nonzero, as it does on SIGTERM; at its end
it stops any process of its own still running.

1. build       - compile every kernel of areal_tpu_torch/csrc with nvcc for
                 sm_90a (one nvcc per source, in parallel).
2. parity      - hold each kernel against its plain PyTorch version on the
                 card, at the serving and training paths' shapes, with
                 inputs made from --seed; the attention kernels' tile-pair
                 counts against the skip predicate and two runs bit-equal;
                 time kernel, plain version and (where one exists) one
                 PyTorch library call (the forward, paged decode and both
                 GAE entries by the device time of their kernels beside
                 the whole call, the backward with CUDA events); the
                 W8A16 matmul at the decode path's launches (wq|wk|wv and
                 w_gate|w_up grouped, gpt2's 50257-column head too) for
                 16, 37 and 80 rows against dequantize + cuBLAS, timed
                 beside bf16 torch.matmul on the unquantized weight and
                 torch._weight_int8pack_mm, and summed over one decode
                 step at 28 layers plus the head; --w8a16-sweep adds the
                 step's time over ring stages, chunks a stage and CTAs
                 an SM.
3. serve_bf16  - a ServingEngine at the full width of
                 DeepSeek-R1-Distill-Qwen-1.5B and 4 of its 28 layers
                 (seeded random weights; cut for the run's time limit, to
                 14 when the recover phase joined and to 4 when the
                 agentic phase did, as phases 4-7 and 9)
                 serves a mix of requests with a bf16 KV pool; launch
                 counts of every kernel on that path must be > 0.
                 --profile-serving adds the profiled windows.
4. serve_int8  - the same with kv_cache_dtype="int8".
5. interrupt   - update_params mid-generation returns partial results
                 with interrupted=True and the new version goes live.
6. spec        - n-gram speculative decoding and int8 decode weights at
                 the serving phases' width, depth and params (16 slots x
                 4096 tokens, 128-token pages): (a) 16 greedy requests of
                 256 tokens (half a 64-token span repeated 4-8 times, half
                 fresh) through a plain engine and one with draft length
                 4 over bigrams: the speculative outputs pass the
                 teacher-forced check, each request's tokens equal the
                 plain engine's up to the first token where they part
                 (the teacher-forced top-2 gap there within 0.1 nats; the
                 count of requests that part is printed), more than one
                 token a step, paged_decode_bf16 launched; (b) sampled
                 requests (temperature 1, top-p 0.9) on the speculative
                 engine: valid ids, median |logprob - the forward's|
                 within 0.05; (c) the int8 pool, speculation and int8
                 weights in one engine: first tokens equal the bf16
                 engine's, greedy tokens pass the teacher-forced check on
                 the dequantized decode weights w_q * s,
                 w8a16_matmul_bf16 and paged_decode_int8 launched; then
                 a GenerationServer with both options takes an HTTP wave
                 (/metrics: areal:spec_emitted_tokens >
                 areal:spec_active_steps) and a weight update from a raw
                 dump of perturbed params, after which its greedy tokens
                 equal an engine's on those params (the int8 copy was
                 rebuilt). It prints decode tok/s and the yield of four
                 engines: plain bf16, int8 weights, speculative, and
                 speculative with int8 weights.
7. http        - the port's GenerationServer in process, at the full
                 width and 4 layers, with the qid prefix cache and
                 token-budget admission, driven over HTTP: a mixed wave
                 from 18 client threads (checked as serve_bf16's), six
                 continuations that must hit the prefix cache, the same
                 wave through the engine alone (the server's overhead),
                 greedy requests bit-equal over HTTP and direct, a weight
                 update from a raw dump mid-wave, a stale retry, and
                 shedding; launch counts through the server must be > 0.
8. grad        - at full width and 2 layers, the gradients of the SFT loss
                 through the kernels against the plain attention on the
                 card, leaf by leaf.
9. train       - a TorchTrainEngine at the full width and 4 layers of
                 R1-Distill-Qwen-1.5B (float32 params, bf16 compute): PPO
                 actor inference, one train_step (GAE, advantage
                 normalization, 4 minibatch updates), then 3 SFT steps;
                 launch counts of the forward, both backward kernels and
                 the fused GAE entry (packed_gae_f32) must be > 0.
10. workers     - the trainer half of the worker system through
                 LocalController(ExperimentConfig).run(): a spawned model
                 worker loads the actor from an HF directory of seeded
                 random weights at the full width and 4 of the 28
                 layers (the sft phase trains the same engine through the
                 worker system at 4; float32
                 params, bf16 compute) and pulls 2 steps of the train
                 phase's PPO batch, pushed from this process as a
                 rollout worker would; the master runs 2 actor_train
                 steps, each followed by the raw-dump weight hand-off.
                 A GenerationServer here takes the last dump through
                 /update_weights_from_disk; greedy tokens over HTTP must
                 equal an engine's on the dumped params. Launches of the
                 forward, both backward kernels and packed_gae_f32 in the
                 worker, and of the forward and paged_decode_bf16 in the
                 server, must be > 0.
11. async_ppo  - the async RL loop through the port's entry point,
                 areal_tpu_torch.training.main_async_ppo.main(argv) with
                 the reference's override keys: a GenerationServer (bf16
                 pool, 16 slots x 4096 tokens), the gserver manager, a
                 rollout worker running the math agent and env over a
                 seeded prompt set under a tiny tokenizer, and a model
                 worker training the actor at full width and 4 of the 28
                 layers (the weight_plane phase runs the loop at 4 too;
                 float32 params, bf16 compute) for 2 steps at
                 max_head_offpolicyness 1. The fanout must land versions
                 1 and 2 on the server, every trained sample must be within
                 the staleness bound, and launches of the forward and
                 paged_decode_bf16 in the server and of the forward, both
                 backward kernels and packed_gae_f32 in the model worker
                 must be > 0.
12. sync_ppo   - sync PPO through the port's entry point,
                 areal_tpu_torch.training.main_sync_ppo.main(argv) with
                 the reference's override keys, at the full width and 4
                 of the 28 layers (SYNC_LAYERS; float32 params, bf16
                 compute, remat): one model worker builds ppo-math with the
                 actor, the reference, the reward (mock backend) and the
                 critic (critic@0 for inference, critic@1 trained), all
                 from one HF directory of seeded random weights under the
                 tiny tokenizer, and runs 2 steps over 64 seeded math
                 prompts (256-1024 tokens): 8 prompts x 4 answers of 256
                 tokens generated in the actor's engine at temperature 1
                 (flash prefill, paged_decode_bf16 decode steps), graded,
                 the reference logprobs and the critic's values, then the
                 critic's and the actor's PPO updates (4 minibatches, GAE).
                 Gates: two steps with finite actor and critic stats;
                 launches of the forward, both backward kernels,
                 packed_gae_f32 and paged_decode_bf16 in the worker > 0;
                 on step 1's first actor minibatch (the generator's
                 logprobs against the training forward's on the same
                 weights), their mean |difference| within SYNC_LP_TOL and
                 the importance weight within 0.02 of 1. It prints each
                 MFC's seconds, actor_gen's tokens/s, the step times, each
                 shard's build seconds and the worker's peak device
                 memory; then, in this process, how many of 16 greedy
                 prompts the batch generator and a ServingEngine agree on
                 (not gated), and the offload of a train engine of the
                 same depth: bytes freed, its seconds, the lazy restore's
                 seconds, and a forward after the restore bit-equal to
                 one before (gated).
13. disagg     - disaggregated serving at full width and 4 of the 28
                 layers (for the run's time limit): a prefill
                 server P (bf16 pool), decode servers D (bf16 pool, a KV
                 tier, a small prefix budget) and D8 (int8 pool), a
                 unified server U (the drain target) behind the gserver
                 manager (pools, prefix index, elastic re-roles), and a
                 unified int8 server U8 outside it, each a process of its
                 own (16 slots x 4096 tokens, 128-token pages, 1024-token
                 chunks). A 16-request wave (prompts 1025-3072 tokens, 128
                 greedy tokens) paired P -> D must equal U's tokens for the
                 same work (the first token, then the continuation); the
                 wave paired P -> D8 passes the teacher-forced check; every
                 handoff succeeds (no fallback); the int8 pages D8 writes
                 from the bf16 wire equal U8's byte for byte; continuations
                 hit D's parked or spilled-and-restored prefixes with U's
                 tokens (spills and restores > 0, no prefix lost); the
                 manager drains D (every prefix migrates, D exits 0, a
                 migrated session restores on U with U's tokens); a prompt
                 burst makes the sizer re-role U and routing follows.
                 Launches of the forward, paged_decode_bf16 and
                 paged_decode_int8 in the fleet must be > 0.
14. weight_plane - the weight-distribution plane at full width and 4
                 of the 28 layers: (a) this process dumps version 1 of
                 perturbed float32 params with the int8 companion and
                 serves it from a WeightPlaneSource registered as a
                 trainer's; three GenerationServer processes behind a
                 GserverManager with weight_plane=True at fanout degree 1
                 (the chain origin -> S0 -> S1 -> S2) serve a greedy wave
                 while it fans out and cuts over: requests in flight come
                 back interrupted and finish on version 1, each server's
                 greedy tokens equal an engine's on the dumped params, the
                 origin sends one payload and the peers two; (b) version
                 2 on the int8 wire to two servers by /distribute_weights
                 and /cutover_weights: the held leaves equal
                 dequantize_wire_leaf(quantize_wire_leaf(x)) bit for bit
                 and the greedy tokens an engine's on them; (c), the phase
                 plane_loop: the async
                 RL loop of phase 11 at 4 layers and max_head_offpolicyness
                 0 with gen_weight_plane=true, two servers at fanout
                 degree 1: versions 1 and 2 land on both through the
                 plane. Both depths were cut since the sft phase joined
                 the default run, the fleet's again (14 to 7) when the
                 sync_ppo phase did, both (7 to 4) when the agentic phase
                 did.
                 The forward and paged_decode_bf16 must launch on every
                 server after its last cutover, and the loop's four kernels
                 (forward, both backward kernels, packed_gae_f32) > 0.
15. sft        - supervised fine-tuning through the port's entry point,
                 areal_tpu_torch.training.main_sft.main(argv) with the
                 reference's override keys, at the full width and 4 of
                 the 28 layers (for the run's time limit: 7 since the
                 recover phase joined, 4 since the agentic phase did;
                 float32 params, bf16 compute,
                 remat): a model
                 worker loads an HF directory of seeded random weights and
                 64 prompt/answer rows (prompts of 256-1024 and answers of
                 128-512 tokens under a tiny tokenizer), trains 3 steps of
                 16 sequences, saves in the HF format and answers the
                 "evaluate" broadcast. The save must hold its config,
                 weights and tokenizer, every leaf finite and moved;
                 SFTInterface.evaluate over the 64 rows must read a lower
                 eval_loss on it than on the initial weights; a
                 GenerationServer on the save (model_path) and one that
                 takes it through /update_weights_from_disk ("source":
                 "hf") must give an engine's greedy tokens on the saved
                 params. The forward and both backward kernels in the
                 worker, and the forward and paged_decode_bf16 in the
                 servers, must launch.
16. recover    - checkpoint and recovery through main_sft at the full
                 width and 4 of the 28 layers (float32 params, bf16
                 compute, remat, a constant LR, no warmup), with
                 recover_mode=auto, recover_retries=1,
                 exp_ctrl.ckpt_freq_steps=2 and AREAL_CKPT_ASYNC=1 in the
                 worker: the first incarnation trains steps 1-3 with an
                 async engine-state checkpoint at step 2, and its master
                 fails at the top of step 4 (master.step armed to raise
                 in this process); the launcher's loop relaunches, the
                 master resumes from the step-2 recover record and the
                 worker restores the step-2 engine state and dataloader
                 cursor. Gates: (a) exactly one relaunch; (b) the record
                 reads global step 2 at the relaunch (its manifest
                 areal-train-ckpt/v1) and 5 at the end (the reference's
                 resume counts last_step_info.next(), so the two steps of
                 the second incarnation are numbered 4 and 5); (c) the
                 second incarnation's first step equals the first's step
                 3 in every sft/* stat; (d) the forward and both backward
                 kernels launch in each incarnation; (e) each worker
                 leaves with no pending checkpoint write and the final
                 checkpoint committed. It prints the checkpoint's bytes,
                 the trainer's stall (the "ckpt" broadcast and the
                 worker's areal:train_ckpt_stall_ms), the writer's seconds
                 and GB/s, the restore's seconds, the time to recover
                 (the failure to the repeated step's stats) and the
                 worker's peak device memory; then, in this process on an
                 engine of the same depth, the stall of a synchronous
                 save and of a snapshot into pinned host memory.
17. agentic    - async PPO on multi-turn tool-use episodes through
                 main_async_ppo.main(argv) with agent_type=tool-use,
                 agent_num_turns=3 and agent_scripted_tool_turns=2 (turn
                 0 calls python, turn 1 the calculator, turn 2 answers;
                 each later turn a continuation of the same qid, 128 new
                 tokens a turn), at the full width and 4 of the 28 layers
                 (AGENTIC_LAYERS, 7 until the fleet phase joined): one
                 server (bf16 pool, the prefix cache on), 32 math prompts of 256-768 tokens, 8 episodes
                 a step, 2 steps at max_head_offpolicyness 1 under
                 AREAL_TASK_STALENESS_WINDOWS=agentic:1, and two reward
                 executors (python -m areal_tpu_torch.system.
                 reward_executor, two warm workers each), executor 0
                 armed to die on its first submit. It runs phase 11's
                 function with the agentic options, so phase 11's gates
                 hold too: the fanout lands versions 1 and 2 on the
                 server, and every trained episode's lag (train step -
                 version_start) is at most the agentic window. Its own
                 gates: (1) two steps,
                 finite actor stats; (2) every trained episode 3 turns
                 and 2 tool calls, no episode failed, every python
                 observation "42"; (3) executor 0 exited and the
                 survivor ran at least one job an episode, no python
                 observation an error; (4) the continuation chunks
                 re-prefilled under half their prompt tokens, prefix-
                 cache hits > 0; (5) the window, as above (the mean
                 perf/task_staleness_agentic is printed); (6) step 1's first minibatch's mean |lp_gen - lp_train|
                 over the concatenated turns within SYNC_LP_TOL; (7) the
                 forward and paged_decode_bf16 launched in the server,
                 both backward kernels and packed_gae_f32 in the model
                 worker. It prints the phase's seconds, episodes/s, each
                 turn's median re-prefill and the executors' counters.
18. fleet      - the async loop keeps its fleet up through failures:
                 main_async_ppo.main(argv) at the full width and 4 of the
                 28 layers (FLEET_LAYERS) with n_generation_servers=3,
                 gen_weight_plane=true, gen_weight_fanout=2,
                 gen_weight_wire_dtype=int8, 128-token answers,
                 n_rollout_workers=2, worker_restarts=2
                 (--fleet-worker-restarts), recover_mode=disabled, 4
                 steps, AREAL_RPC_BREAKER_FAILS=2,
                 AREAL_RPC_BREAKER_COOLDOWN_S=5 and server 1's /generate
                 armed to fail 6 requests in a row. A side thread
                 (FleetChaos) delays the next 2 chunks the fanout tree's
                 first parent serves by 1 s, SIGKILLs server 2 once
                 rollouts run and SIGSTOPs rollout worker 1 3 s later, by
                 the pids in their health records. Gates: (a) /status
                 shows server 1's breaker open and the trace routes
                 nothing to it inside an open window; (b) the controller
                 restarted server 2 once in place, the manager moved it
                 to its new url, and its successor's first request was
                 served at no older a version than it was routed at
                 (printed: the seconds from the kill, time to serve
                 again); (c) rollout
                 worker 1 was restarted as hung (heartbeat went stale)
                 and the manager gave its slots back; (d) the servers'
                 chunk reads hedged (hedges >= 1, hedge wins >= 1) and
                 every completed fetch took each byte once; no restart
                 but those two (a hang false positive fails); all 4 steps
                 without a relaunch, with phase 11's gates (every trained
                 sample's lag within max_head_offpolicyness; of the
                 landed versions, each at most once and the last on every
                 server but the killed one, which gate (b) holds), the
                 forward, paged_decode_bf16, both backward kernels and
                 packed_gae_f32 launched. With --fleet-worker-restarts 0
                 it must fail at gate (b): the run escalates.

Before the last line it prints the card's name and power limit (as
nvidia-smi reports them) and one {"kernels": [...]} JSON line; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
# Parity limits for the bf16 attention outputs. ATOL caps the error
# anywhere; RTOL is per output row (one query head's hd values) against
# that row's largest reference value, about 2.5 bf16 ulps there, so a
# long-context row (values ~0.03) is held as tightly as a short one (~1).
ATOL = 2e-2
RTOL = 2e-2
LSE_ATOL = 1e-3  # f32 logsumexp
# Gradients of attention (bf16) have no fixed scale (dk and dv sum over
# thousands of queries), so their limits are relative: every output row
# (one head's hd values of one token) within RTOL of that row's largest
# reference value, and the whole tensor within GRAD_TOL of its largest. A
# row's scale is taken as at least ROW_FLOOR of the tensor's: the dq row of
# a sequence's first token is dout.v - dout.out = 0 but for rounding.
GRAD_TOL = 2e-2
ROW_FLOOR = 1e-3
GAE_RTOL = 1e-5  # f32 scan, against max(1, max|ref|)
# Operations a token of the fused GAE entry: delta (3), the scan's
# multiply-add (2), x + V (1).
PACKED_GAE_FLOPS = 6.0
# The PPO step's batch as rows of 4096; few long chain-of-thought rows; a
# large batch (512 prompts x 16 answers x 2k tokens).
GAE_TIMING_SHAPES = ((16, 4096), (2, 32768), (4096, 4096))
# Shapes at which both GAE plan modes (a whole row a CTA; one-chunk tiles
# across CTAs) are timed beside each other, on both sides of each of
# gae_plan's two conditions (rows of at most 4 chunks; R >= SMs, 132).
GAE_PLAN_SHAPES = ((64, 4096), (4096, 4096), (66, 8192), (66, 16384), (132, 16384),
                   (33, 32768))
# SFT-loss gradients through the kernels against the plain attention, bf16
# compute end to end: per leaf, against the leaf's largest reference value.
LEAF_TOL = 5e-2
# Depths of the serving phases (serve_bf16, serve_int8, interrupt, spec, http)
# and of the train phase, cut from the model's 28 layers to 14 when the
# recover phase joined the default run and to 4 when the agentic phase
# did (the run's time limit; widths and gates unchanged).
SERVE_LAYERS = 4
TRAIN_LAYERS = 4
PHASES = ("build", "parity", "serve_bf16", "serve_int8", "interrupt", "spec", "http", "grad",
          "train", "workers", "async_ppo", "sync_ppo", "disagg", "weight_plane", "plane_loop",
          "sft", "recover", "agentic", "fleet")
# The train phase at real size; a rehearsal on the CPU passes smaller ones.
TRAIN_SIZES = dict(n_prompts=8, group=4, prompt=(128, 512), response=(256, 3072),
                   row_len=4096, max_tokens_per_mb=16384, n_minibatches=4,
                   sft_seqs=8, sft_steps=3)


def log(msg: str) -> None:
    print(msg, flush=True)


# The default run has 1200 s. Past RUN_BUDGET_S (from the script's start)
# it fails by itself: every process it started is stopped, then it exits
# nonzero, before anything outside has to stop it.
RUN_BUDGET_S = 1150.0
T_START = time.monotonic()


def become_subreaper() -> None:
    """Adopt this run's orphans (PR_SET_CHILD_SUBREAPER): a worker whose
    parent died stays a descendant, so stop_descendants still finds it."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def descendants(root: int):
    """Pids of every live descendant of `root`, read from /proc (a zombie,
    which has exited already, is not live)."""
    children = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        if state != "Z":
            children.setdefault(int(ppid), []).append(int(d))
    out, todo = [], [root]
    while todo:
        for c in children.get(todo.pop(), ()):
            out.append(c)
            todo.append(c)
    return out


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip()
    except OSError:
        return "?"


def stop_descendants(keep=("resource_tracker",)) -> list:
    """SIGKILL every descendant of this process (a stopped one too) but
    those whose command line holds a word of `keep`, reap them, and
    return their command lines."""
    gone = []
    for _ in range(3):
        pids = [p for p in descendants(os.getpid())
                if not any(k in _cmdline(p) for k in keep)]
        if not pids:
            break
        for p in pids:
            gone.append(_cmdline(p))
            try:
                os.kill(p, signal.SIGKILL)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + 5.0
        for p in pids:
            while time.monotonic() < deadline:
                try:
                    if os.waitpid(p, os.WNOHANG)[0]:
                        break
                except ChildProcessError:
                    break  # not our child, or reaped already
                time.sleep(0.05)
    return gone


def guard_run(budget_s: float) -> None:
    """Stop every process of the run and exit nonzero on SIGTERM or
    SIGHUP, and once the run is `budget_s` seconds old (0: no budget)."""

    def bail(why: str, code: int) -> None:
        log(f"{why}: stopping every process this run started")
        gone = stop_descendants(keep=())
        log(f"  stopped {len(gone)} process(es)")
        for lane in _OPEN_LANES:
            with open(lane["text"]) as f:
                for line in f.read().splitlines():
                    print(f"  [side, stopped] {line}", file=sys.stderr, flush=True)
        sys.stdout.flush()
        os._exit(code)

    def on_signal(signum, _frame):
        bail(f"signal {signum}", 128 + signum)

    for s in (signal.SIGTERM, signal.SIGHUP):
        signal.signal(s, on_signal)
    if budget_s > 0:
        def watch():
            left = budget_s - (time.monotonic() - T_START)
            if left > 0:
                time.sleep(left)
            bail(f"the run passed its budget of {budget_s:.0f} s", 3)

        threading.Thread(target=watch, name="run-budget", daemon=True).start()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() over `iters` runs, each bracketed by
    CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, names=None, iters: int = 20, warmup: int = 3, per_call=None) -> float:
    """Device milliseconds per call of fn(): the time of the CUDA kernels
    it launched whose names contain one of `names` (all of them when
    None), summed by torch.profiler. CUDA events around a call also count
    the host's time to enqueue it, which for a short kernel behind a
    Python wrapper is the longer of the two. `per_call`, where given, is
    how many such kernels one call launches: the time is then the mean of
    the launches the profiler saw, times `per_call`, so a window that lost
    some of its device events still reads true; one that lost more than
    half is taken again. `per_call="auto"` (a library call whose kernel
    count is not known beforehand) takes it as the launches seen over the
    calls, rounded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # A profiling window now and then comes back without some or all of
    # its device events; such a window is taken again, up to four times.
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and (names is None or any(n in e.key for n in names))]
        us = sum(e.self_device_time_total for e in seen)
        if us > 0 and per_call is None:
            return us / 1e3 / iters
        n = sum(e.count for e in seen)
        if per_call == "auto":
            per_call = max(1, round(n / iters))
        if us > 0 and 2 * n >= per_call * iters:
            if n != per_call * iters:
                log(f"  profiler: {n} of {per_call * iters} launches of {names} seen")
            return us / 1e3 / n * per_call
    raise RuntimeError(f"the profiler saw no device time, or not all launches, for kernels "
                       f"{names}")


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ----------------------------------------------------------------------
# Phase 2: kernel parity and timing
# ----------------------------------------------------------------------


def row_errors(out, ref, floor=1e-6):
    """(max abs error, max over output rows of max|out - ref| / max|ref|),
    a row's max|ref| taken as at least `floor`."""
    d = (out.float() - ref.float()).abs().amax(dim=-1)
    m = ref.float().abs().amax(dim=-1).clamp(min=floor)
    return d.max().item(), (d / m).max().item()


def packed_rows(rng, R, T, seg_lens_per_row):
    seg = np.zeros((R, T), np.int32)
    pos = np.zeros((R, T), np.int32)
    for r, lens in enumerate(seg_lens_per_row):
        t = 0
        for s, n in enumerate(lens):
            seg[r, t:t + n] = s + 1
            pos[r, t:t + n] = np.arange(n)
            t += n
    return seg, pos


def flash_case(torch, rng, dev, R, T, Hq, Hkv, hd, seg_lens_per_row):
    bf = torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((R, T, Hq, hd), np.float32)).to(dev, bf)
    k = torch.from_numpy(rng.standard_normal((R, T, Hkv, hd), np.float32)).to(dev, bf)
    v = torch.from_numpy(rng.standard_normal((R, T, Hkv, hd), np.float32)).to(dev, bf)
    seg, pos = packed_rows(rng, R, T, seg_lens_per_row)
    return q, k, v, torch.from_numpy(seg).to(dev), torch.from_numpy(pos).to(dev)


def plain_lse(torch, q, k, seg, pos, scale):
    from areal_tpu_torch.ops.attention import segment_causal_mask

    R, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(R, T, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("rqhgd,rkhd->rhgqk", qg, k.float()) * scale
    mask = segment_causal_mask(seg, pos)[:, None, None]
    s = torch.where(mask, s, float("-inf"))
    lse = torch.logsumexp(s, dim=-1).reshape(R, Hq, T)
    return lse, mask.any(dim=-1).reshape(R, 1, T).expand(R, Hq, T)


def time_flash_fwd(torch, q, k, v, seg, pos, seg_lens, scale, plain_iters=5):
    """The forward kernel at one shape: its device time and bound, the
    pre-pass (tile ranges), the whole wrapper call, and the plain
    version's and SDPA's times on the same inputs."""
    from areal_tpu_torch.ops.attention import (
        _flash_fwd, fwd_tile, reference_packed_attention, segment_causal_mask,
        tile_segment_ranges)

    R, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    # Only valid tokens need q/k/v reads; out, lse, seg and pos span all of T.
    valid = [n for row in seg_lens for n in row]
    flops = sum(2.0 * n * n * hd * Hq for n in valid)
    nbytes = (sum(valid) * (Hq + 2 * Hkv) * hd * 2 + R * T * Hq * hd * 2
              + 2 * R * T * 4 + R * Hq * T * 4)
    b_ms, b_by = bound(flops, nbytes)
    ranges = tile_segment_ranges(seg, fwd_tile())
    ms = device_ms(lambda: _flash_fwd(q, k, v, seg, pos, scale, ranges), ("flash_fwd_kernel",),
                   per_call=1)
    pre_ms = device_ms(lambda: tile_segment_ranges(seg, fwd_tile()), per_call="auto")
    call_ms = time_ms(lambda: _flash_fwd(q, k, v, seg, pos, scale))
    plain_ms = time_ms(lambda: reference_packed_attention(q, k, v, seg, pos),
                       iters=plain_iters, warmup=1)
    # Library yardstick: one SDPA call with an explicit boolean mask (k/v
    # expanded to the q heads and the mask built beforehand, untimed), its
    # kernels' device time.
    group = Hq // Hkv
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    mask = segment_causal_mask(seg, pos)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), per_call="auto")
    return dict(shape=f"R={R} T={T} Hq={Hq} Hkv={Hkv} hd={hd} valid={sum(valid)} "
                f"seqs={len(valid)}",
                ms=ms, pre_pass_ms=pre_ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def parity_flash(torch, rng, dev, report, case_rng):
    """The forward kernel against its plain version. The training-shape
    case draws from `case_rng`, so the draws of `rng`, and the later
    phases' batches, are those of a run without it."""
    from areal_tpu_torch.ops.attention import (
        _flash_fwd, fwd_tile, live_tile_pairs, reference_packed_attention, tile_segment_ranges)

    cases = [
        # ragged packed rows: several segments, padding tail, T % 128 != 0
        ("ragged_T1000", rng, 2, 1000, 12, 2, 128, [[300, 220, 417], [999]]),
        ("T4096", rng, 1, 4096, 12, 2, 128, [[4096]]),
        ("hd64", rng, 2, 333, 8, 2, 64, [[100, 200], [5, 300, 27]]),
    ]
    # The serving path's prefill shape: 8 prompts of 512-1024 tokens, one
    # per row, padded to a whole number of 128-token pages.
    lens = rng.integers(512, 1025, size=8)
    cases.append(("prefill_R8_T1024", rng, 8, 1024, 12, 2, 128, [[int(n)] for n in lens]))
    # The training shape: rows of 4096 tokens, 2-6 sequences and a padding
    # tail each (the backward's timed case).
    cases.append(("train_R4_T4096", case_rng, 4, 4096, 12, 2, 128,
                  random_seg_lens(case_rng, 4, 4096)))
    timed = ("prefill_R8_T1024", "train_R4_T4096")
    errs, rels, timings, counted = [], [], {}, {}
    for name, gen, R, T, Hq, Hkv, hd, seg_lens in cases:
        q, k, v, seg, pos = flash_case(torch, gen, dev, R, T, Hq, Hkv, hd, seg_lens)
        scale = hd ** -0.5
        out, lse = _flash_fwd(q, k, v, seg, pos, scale)
        # Two runs bit-equal (remat runs the forward twice), and a counting
        # launch: the (q head, q tile, kv tile) steps its CTAs ran must equal
        # the skip predicate's count, with outputs bit-equal to the plain
        # launch's.
        out2, lse2 = _flash_fwd(q, k, v, seg, pos, scale)
        ranges = tile_segment_ranges(seg, fwd_tile())
        out3, lse3, pairs = _flash_fwd(q, k, v, seg, pos, scale, ranges, count_pairs=True)
        counted[name] = int(pairs.sum().item())
        predicate = int(live_tile_pairs(ranges).sum().item()) * Hq
        n_tiles = ranges.shape[1]
        causal_only = R * n_tiles * (n_tiles + 1) // 2 * Hq
        same = all(torch.equal(a, b) for a, b in ((out, out2), (lse, lse2), (out, out3),
                                                  (lse, lse3)))
        log(f"  flash {name} tile pairs (q head, q tile, kv tile): counted by the kernel "
            f"{counted[name]}, the skip predicate {predicate}, causal only {causal_only}; "
            f"two runs and the counting launch bit-equal: {same}")
        if not (same and counted[name] == predicate):
            raise AssertionError(f"flash {name}: runs differ or the kernel's tile pairs "
                                 f"disagree with the skip predicate")
        del out2, lse2, out3, lse3
        ref = reference_packed_attention(q, k, v, seg, pos)
        err, rel = row_errors(out, ref)
        del ref
        lse_ref, has_key = plain_lse(torch, q, k, seg, pos, scale)
        lse_err = (lse - lse_ref).abs()[has_key].max().item()
        del lse_ref, has_key
        pad_zero = out.float()[seg == 0].abs().max().item() if (seg == 0).any() else 0.0
        log(f"  flash {name}: max_abs_err={err:.3e} (tol {ATOL}) max_row_rel_err={rel:.3e} "
            f"(tol {RTOL}) lse_err={lse_err:.3e} (tol {LSE_ATOL}) pad_rows_max={pad_zero:.1e}")
        if not (err <= ATOL and rel <= RTOL and lse_err <= LSE_ATOL and pad_zero == 0.0
                and torch.isfinite(out.float()).all()):
            raise AssertionError(f"flash {name} disagrees with its plain version")
        errs.append(err)
        rels.append(rel)
        if name in timed:
            timings[name] = time_flash_fwd(torch, q, k, v, seg, pos, seg_lens, scale,
                                           plain_iters=5 if T <= 1024 else 2)
            t = timings[name]
            log(f"  flash timing {t['shape']}: kernel {t['ms']:.4f} ms (device), pre-pass "
                f"{t['pre_pass_ms']:.4f} ms, whole call {t['call_ms']:.3f} ms (events); plain "
                f"{t['plain_ms']:.3f} ms, sdpa {t['library_ms']:.4f} ms (device), bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    # The kernels line carries the serving path's prefill shape; the
    # training shape rides along.
    t = timings["prefill_R8_T1024"]
    report["flash_attn_fwd_bf16"] = dict(
        name="flash_attn_fwd_bf16", route="cuda",
        source="areal_tpu_torch/csrc/flash_attn.cu",
        replaces="areal_tpu/ops/pallas/flash_attn.py:119",
        max_abs_err=max(errs), max_row_rel_err=max(rels), ms=t["ms"],
        pre_pass_ms=t["pre_pass_ms"], call_ms=t["call_ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], shape=t["shape"],
        tile_pairs_counted=counted["prefill_R8_T1024"],
        training_shape=dict(timings["train_R4_T4096"],
                            tile_pairs_counted=counted["train_R4_T4096"]))


def paged_case(torch, rng, dev, B, Hq, Hkv, hd, pg, lengths, int8, trash_rows=(),
               shared_row=False):
    from areal_tpu_torch.engine.paged import quantize_kv

    P = max(-(-int(n) // pg) for n in lengths)
    n_used = 1 if shared_row else B
    N = 1 + n_used * P  # page 0 is the trash page
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    pi = np.zeros((B, P), np.int32)
    for b in range(B):
        if b in trash_rows:
            continue  # an inactive slot: its row routes to the trash page
        row = perm[:P] if shared_row else perm[b * P:(b + 1) * P]
        pi[b] = row
    q = torch.from_numpy(rng.standard_normal((B, Hq, hd), np.float32)).to(dev, torch.bfloat16)
    kf = torch.from_numpy(rng.standard_normal((Hkv, N, pg, hd), np.float32)).to(dev)
    vf = torch.from_numpy(rng.standard_normal((Hkv, N, pg, hd), np.float32)).to(dev)
    if int8:
        kw, ks = quantize_kv(kf)
        vw, vs = quantize_kv(vf)
        k_pool, v_pool = (kw, ks[..., 0].contiguous()), (vw, vs[..., 0].contiguous())
    else:
        k_pool, v_pool = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    lens = torch.tensor(np.asarray(lengths, np.int32), device=dev)
    page_indices = torch.from_numpy(pi).to(dev)
    if shared_row:
        page_indices = page_indices[:1].expand(B, P)
    return q, k_pool, v_pool, lens, page_indices


def paged_bound(Hq, Hkv, hd, int8, lengths, n_rows, n_kv_tokens, pi_words):
    """Least time of one paged-attention call: each row's q read and out
    written once, the K/V of `n_kv_tokens` distinct tokens read once, the
    page table and lengths once; two products per (row, head, token)."""
    per_tok = Hkv * 2 * ((hd + 4) if int8 else hd * 2)  # K and V bytes
    nbytes = n_kv_tokens * per_tok + 2 * n_rows * Hq * hd * 2 + pi_words * 4 + n_rows * 4
    flops = float(sum(lengths)) * Hq * hd * 4
    return bound(flops, nbytes)


def parity_paged(torch, rng, dev, report, int8: bool, case_rng):
    """Both modes of the paged kernel against the plain version: decode
    steps (a page row per sequence) and chunk steps (rows of one prompt
    sharing one page row). The timed chunk case draws from `case_rng`, so
    the draws of `rng`, and the later phases' requests, are those of a run
    without it."""
    from areal_tpu_torch.engine.paged import (
        _paged_attention_xla, _paged_decode_kernel, _sm_count, split_plan)

    kname = "paged_decode_int8" if int8 else "paged_decode_bf16"
    Hq, Hkv, hd = 12, 2, 128
    cases = [
        ("B1_pg128", rng, 1, 128, [3001], (), False),
        ("B16_pg16_trash", rng, 16, 16,
         list(rng.integers(1, 4097, size=15)) + [4096], (3, 9), False),
        ("B16_pg128", rng, 16, 128, list(rng.integers(1, 4097, size=16)), (), False),
        ("B1_pg16", rng, 1, 16, [17], (), False),
        # chunked prefill: 256 rows share one page row, staggered lengths
        ("chunk256_shared_row", rng, 256, 128, list(2048 + np.arange(256)), (), True),
        # the third 1024-token chunk of a 3000-token prompt: rows at
        # positions 2048..3071 (952 valid, the rest inactive rows that the
        # engine still runs) over one page row of 24 pages
        ("chunk1024_start2048", case_rng, 1024, 128, list(2048 + 1 + np.arange(1024)), (),
         True),
        # 100 rows (off the 64-row tile) from position 37 (mid-page) over
        # 16-token pages: a 64-token kv tile spans four pages
        ("chunk100_start37_pg16", case_rng, 100, 16, list(37 + 1 + np.arange(100)), (), True),
    ]
    errs, rels = [], []
    for name, gen, B, pg, lengths, trash, shared in cases:
        q, kp, vp, lens, pi = paged_case(torch, gen, dev, B, Hq, Hkv, hd, pg,
                                         lengths, int8, trash, shared)
        scale = hd ** -0.5
        out = _paged_decode_kernel(q, kp, vp, lens, pi, scale)
        ref = _paged_attention_xla(q, kp, vp, lens, pi, scale)
        err, rel = row_errors(out, ref)
        del ref
        log(f"  {kname} {name}: max_abs_err={err:.3e} (tol {ATOL}) "
            f"max_row_rel_err={rel:.3e} (tol {RTOL})")
        if not (err <= ATOL and rel <= RTOL and torch.isfinite(out.float()).all()):
            raise AssertionError(f"{kname} {name} disagrees with its plain version")
        errs.append(err)
        rels.append(rel)
        if name == "chunk1024_start2048":
            b_ms, b_by = paged_bound(Hq, Hkv, hd, int8, lengths, B, max(lengths), pi.shape[1])
            chunk = dict(
                shape=f"B={B} rows sharing one page row, lengths {min(lengths)}-"
                      f"{max(lengths)}, Hq={Hq} Hkv={Hkv} hd={hd} pg={pg}",
                ms=device_ms(lambda: _paged_decode_kernel(q, kp, vp, lens, pi, scale),
                             ("paged_chunk_kernel",), per_call=1),
                call_ms=time_ms(lambda: _paged_decode_kernel(q, kp, vp, lens, pi, scale)),
                plain_ms=time_ms(lambda: _paged_attention_xla(q, kp, vp, lens, pi, scale),
                                 iters=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by)
            log(f"  {kname} timing chunk {chunk['shape']}: kernel {chunk['ms']:.4f} ms "
                f"(device), whole call {chunk['call_ms']:.4f} ms (events); plain "
                f"{chunk['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        del q, kp, vp, out
        torch.cuda.empty_cache()
    # Timing at the serving decode shape: 16 slots, page 128, ragged
    # contexts up to 4096 tokens.
    lengths = list(rng.integers(1024, 4097, size=16))
    q, kp, vp, lens, pi = paged_case(torch, rng, dev, 16, Hq, Hkv, hd, 128, lengths, int8)
    scale = hd ** -0.5
    b_ms, b_by = paged_bound(Hq, Hkv, hd, int8, lengths, 16, sum(lengths), pi.numel())
    splits, per = split_plan(16, Hkv, pi.shape[1], _sm_count(q.device.index or 0))
    out = _paged_decode_kernel(q, kp, vp, lens, pi, scale)
    same = torch.equal(out, _paged_decode_kernel(q, kp, vp, lens, pi, scale))
    log(f"  {kname} decode timing shape: {splits} splits of {per} pages over "
        f"{pi.shape[1]} pages a row; two runs bit-equal: {same}")
    if not same:
        raise AssertionError(f"{kname}: two decode runs differ")
    # A split launch runs its splits, then a combine: two kernels a call.
    ms = device_ms(lambda: _paged_decode_kernel(q, kp, vp, lens, pi, scale),
                   ("paged_split_kernel", "paged_combine_kernel"), iters=50,
                   per_call=2 if splits > 1 else 1)
    call_ms = time_ms(lambda: _paged_decode_kernel(q, kp, vp, lens, pi, scale), iters=50)
    plain_ms = time_ms(lambda: _paged_attention_xla(q, kp, vp, lens, pi, scale))
    report[kname] = dict(
        name=kname, route="cuda", source="areal_tpu_torch/csrc/paged_decode.cu",
        replaces=("areal_tpu/ops/pallas/paged_decode_int8.py:109" if int8
                  else "areal_tpu/engine/paged.py:341"),
        max_abs_err=max(errs), max_row_rel_err=max(rels), ms=ms, call_ms=call_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B=16 Hq={Hq} Hkv={Hkv} hd={hd} pg=128 sum_len={int(sum(lengths))}",
        splits=splits, pages_per_split=per, chunk=chunk,
    )
    log(f"  {kname} timing {report[kname]['shape']}: kernel {ms:.4f} ms (device: splits and "
        f"combine), whole call {call_ms:.4f} ms (events); plain {plain_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")


def random_seg_lens(rng, R, T, lo=2, hi=6, pad_max=512):
    """Per row, `lo`..`hi` sequence lengths that fill T less a padding tail."""
    rows = []
    for _ in range(R):
        n = int(rng.integers(lo, hi + 1))
        used = T - int(rng.integers(1, pad_max + 1))
        cuts = np.sort(rng.choice(np.arange(1, used), size=n - 1, replace=False))
        rows.append(np.diff([0, *cuts.tolist(), used]).tolist())
    return rows


def short_seq_lens(rng, R, n, lo, hi):
    """Per row, `n` sequence lengths drawn from lo..hi."""
    return [rng.integers(lo, hi + 1, size=n).tolist() for _ in range(R)]


def time_flash_bwd(torch, q, k, v, dout, seg, pos, seg_lens, out, lse, scale):
    """Both backward kernels at one shape: their times and bounds, and the
    plain backward's and SDPA's backward's times on the same inputs."""
    from areal_tpu_torch.ops.attention import (
        _bwd_delta, _launch_dkv, _launch_dq, bwd_tile, reference_packed_attention_bwd,
        segment_causal_mask, tile_segment_ranges)

    R, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    # Work of the run's inputs: causal pairs within each sequence, reads of
    # valid tokens.
    valid = [n for row in seg_lens for n in row]
    pairs = sum(n * (n + 1) / 2.0 for n in valid)
    product = 2.0 * pairs * hd * Hq  # flops of one [T, T] x hd product
    tok = sum(valid)
    q_bytes, kv_bytes = tok * Hq * hd * 2, tok * Hkv * hd * 2
    stat_bytes = 2 * R * Hq * T * 4 + 2 * R * T * 4  # lse, delta, seg, pos
    full_q, full_kv = R * T * Hq * hd * 2, R * T * Hkv * hd * 2  # outputs span T
    dq_bound = bound(3 * product, 2 * q_bytes + 2 * kv_bytes + stat_bytes + full_q)
    dkv_bound = bound(4 * product, 2 * q_bytes + 2 * kv_bytes + stat_bytes + 2 * full_kv)
    whole_bound = bound(5 * product, 3 * q_bytes + 2 * kv_bytes + stat_bytes
                        + full_q + 2 * full_kv)
    delta = _bwd_delta(out, dout)
    ranges = tile_segment_ranges(seg, bwd_tile())
    args = (q, k, v, dout, seg, pos, lse, delta, ranges)
    dq_ms = time_ms(lambda: _launch_dq(*args, scale), iters=10)
    dkv_ms = time_ms(lambda: _launch_dkv(*args, scale), iters=10)
    pre_ms = time_ms(lambda: (_bwd_delta(out, dout), tile_segment_ranges(seg, bwd_tile())),
                     iters=10)
    plain_ms = time_ms(lambda: reference_packed_attention_bwd(
        q, k, v, seg, pos, dout, out=out, lse=lse), iters=3, warmup=1)
    # Library yardstick: autograd through one SDPA call with the boolean
    # mask (its forward untimed), which gives dq, dk and dv together.
    group = Hq // Hkv
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
    vt = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous().requires_grad_(True)
    mask = segment_causal_mask(seg, pos)[:, None]
    o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    do = dout.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), do, retain_graph=True),
                     iters=10)
    return dict(
        shape=f"R={R} T={T} Hq={Hq} Hkv={Hkv} hd={hd} valid={tok} seqs={len(valid)}",
        dq_ms=dq_ms, dkv_ms=dkv_ms, pre_pass_ms=pre_ms, plain_ms=plain_ms, library_ms=lib_ms,
        dq_bound=dq_bound, dkv_bound=dkv_bound, whole_bound=whole_bound)


def log_flash_bwd_timing(t):
    log(f"  flash_bwd timing {t['shape']}: dq {t['dq_ms']:.3f} ms (bound "
        f"{t['dq_bound'][0]:.4f} ms, {t['dq_bound'][1]}), dk/dv {t['dkv_ms']:.3f} ms (bound "
        f"{t['dkv_bound'][0]:.4f} ms, {t['dkv_bound'][1]}), pre-pass (delta, tile ranges) "
        f"{t['pre_pass_ms']:.3f} ms; whole backward bound {t['whole_bound'][0]:.4f} ms "
        f"({t['whole_bound'][1]}); plain {t['plain_ms']:.1f} ms, sdpa backward "
        f"{t['library_ms']:.3f} ms")


def count_tile_pairs(torch, name, q, k, v, dout, seg, pos, out, lse, scale, got):
    """A counting launch of each backward kernel: the (q head, q tile, kv
    tile) products its CTAs ran, as the kernel counted them, which must
    equal the plain skip predicate's count; the counting launch's outputs
    must be bit-equal to the plain launch's `got`. Returns the two counts
    and whether both checks held."""
    from areal_tpu_torch.ops.attention import (
        _bwd_delta, _launch_dkv, _launch_dq, bwd_tile, live_tile_pairs, tile_segment_ranges)

    Hq = q.shape[2]
    ranges = tile_segment_ranges(seg, bwd_tile())
    args = (q, k, v, dout, seg, pos, lse, _bwd_delta(out, dout), ranges, scale)
    dq, dq_pairs = _launch_dq(*args, count_pairs=True)
    dk, dv, dkv_pairs = _launch_dkv(*args, count_pairs=True)
    counted = {"dq": int(dq_pairs.sum().item()), "dkv": int(dkv_pairs.sum().item())}
    predicate = int(live_tile_pairs(ranges).sum().item()) * Hq
    R, n = ranges.shape[:2]
    causal_only = R * n * (n + 1) // 2 * Hq
    ok = (counted["dq"] == predicate == counted["dkv"]
          and all(torch.equal(a, b) for a, b in zip((dq, dk, dv), got)))
    log(f"  flash_bwd {name} tile pairs (q head, q tile, kv tile): counted by the kernels "
        f"dq {counted['dq']}, dk/dv {counted['dkv']}; the skip predicate (live_tile_pairs, "
        f"from the inputs) {predicate}; causal only (from the shape) {causal_only}, so "
        f"{counted['dq'] / causal_only:.3f} of it computed; counting launch bit-equal: "
        f"{ok}")
    return counted, ok


def parity_flash_bwd(torch, rng, dev, report, case_rng):
    """Both backward kernels against the plain backward on the same
    inputs: q, k, v, dout and the forward kernel's out and logsumexp (which
    parity_flash holds against the plain forward). The short-sequence and
    one-sequence cases draw from `case_rng`, so the draws of `rng`, and the
    later phases' batches, are those of a run without them."""
    from areal_tpu_torch.ops.attention import (
        _flash_bwd, _flash_fwd, reference_packed_attention_bwd)

    cases = [
        ("ragged_T1000", rng, 2, 1000, 12, 2, 128, [[300, 220, 417], [999]]),
        ("hd64", rng, 2, 333, 8, 2, 64, [[100, 200], [5, 300, 27]]),
        ("all_padding_row", rng, 2, 200, 12, 2, 128, [[64, 100], []]),
        # 32 sequences of 64-200 tokens a row (ragged T): most tile pairs
        # under the diagonal are skipped
        ("short_seqs_R2_T6500", case_rng, 2, 6500, 12, 2, 128,
         short_seq_lens(case_rng, 2, 32, 64, 200)),
        # one sequence a row: the causal-only worst case, nothing skipped
        ("one_seq_R4_T4096", case_rng, 4, 4096, 12, 2, 128, [[4096]] * 4),
        # the training shape: rows of 4096 tokens, 2-6 sequences and a
        # padding tail each
        ("train_R4_T4096", rng, 4, 4096, 12, 2, 128, random_seg_lens(rng, 4, 4096)),
    ]
    timed = ("one_seq_R4_T4096", "train_R4_T4096")
    errs = {"dq": [], "dk": [], "dv": []}
    failed = []
    timings, pairs = {}, {}
    for name, gen, R, T, Hq, Hkv, hd, seg_lens in cases:
        q, k, v, seg, pos = flash_case(torch, gen, dev, R, T, Hq, Hkv, hd, seg_lens)
        dout = torch.from_numpy(gen.standard_normal((R, T, Hq, hd), np.float32)).to(
            dev, torch.bfloat16)
        scale = hd ** -0.5
        out, lse = _flash_fwd(q, k, v, seg, pos, scale)
        got = _flash_bwd(q, k, v, seg, pos, out, lse, dout, scale)
        again = _flash_bwd(q, k, v, seg, pos, out, lse, dout, scale)
        ref = reference_packed_attention_bwd(q, k, v, seg, pos, dout, out=out, lse=lse)
        torch.cuda.synchronize()
        parts = []
        for tname, g, g2, w in zip(("dq", "dk", "dv"), got, again, ref):
            top = w.float().abs().max().item()
            err, rel = row_errors(g, w, floor=ROW_FLOOR * top)
            pad = g.float()[seg == 0].abs().max().item() if (seg == 0).any() else 0.0
            parts.append(f"{tname} abs={err:.3e} of max|ref|={top:.3e} row_rel={rel:.3e} "
                         f"pad_rows_max={pad:.1e}")
            if not (err <= GRAD_TOL * top and rel <= RTOL and pad == 0.0
                    and torch.isfinite(g.float()).all() and torch.equal(g, g2)):
                failed.append(f"{name} {tname}")
            errs[tname].append(err)
        log(f"  flash_bwd {name}: " + "; ".join(parts)
            + f" (limits: {GRAD_TOL} of max|ref|, row {RTOL}; two runs bit-equal)")
        pairs[name], pairs_ok = count_tile_pairs(torch, name, q, k, v, dout, seg, pos, out,
                                                 lse, scale, got)
        if not pairs_ok:
            failed.append(f"{name} tile pairs")
        del got, again, ref
        if name in timed:
            timings[name] = time_flash_bwd(torch, q, k, v, dout, seg, pos, seg_lens,
                                           out, lse, scale)
            log_flash_bwd_timing(timings[name])
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"flash backward disagrees with its plain version, between two "
                             f"runs or with the skip predicate: {failed}")
    # The kernels line carries the training shape, the main path's.
    t = timings["train_R4_T4096"]
    counted = pairs["train_R4_T4096"]
    for kname, replaces, ms, (b_ms, b_by), err, n_pairs in (
            ("flash_attn_bwd_dq_bf16", "areal_tpu/ops/pallas/flash_attn.py:265", t["dq_ms"],
             t["dq_bound"], max(errs["dq"]), counted["dq"]),
            ("flash_attn_bwd_dkv_bf16", "areal_tpu/ops/pallas/flash_attn.py:295", t["dkv_ms"],
             t["dkv_bound"], max(errs["dk"] + errs["dv"]), counted["dkv"])):
        report[kname] = dict(
            name=kname, route="cuda", source="areal_tpu_torch/csrc/flash_attn_bwd.cu",
            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=t["plain_ms"], bound_ms=b_ms,
            bound_by=b_by, library_ms=t["library_ms"], shape=t["shape"],
            tile_pairs_counted=n_pairs,
            note="plain_ms and library_ms time dq, dk and dv together")
    report["flash_attn_bwd_dq_bf16"]["whole_backward"] = dict(
        ms=t["dq_ms"] + t["dkv_ms"] + t["pre_pass_ms"], pre_pass_ms=t["pre_pass_ms"],
        bound_ms=t["whole_bound"][0], bound_by=t["whole_bound"][1])
    one = timings["one_seq_R4_T4096"]
    report["flash_attn_bwd_dq_bf16"]["one_sequence"] = dict(
        shape=one["shape"], ms=one["dq_ms"], bound_ms=one["dq_bound"][0],
        library_ms=one["library_ms"], plain_ms=one["plain_ms"])
    report["flash_attn_bwd_dkv_bf16"]["one_sequence"] = dict(
        shape=one["shape"], ms=one["dkv_ms"], bound_ms=one["dkv_bound"][0],
        library_ms=one["library_ms"], plain_ms=one["plain_ms"])


def gae_batch(rng, R, T, seg_len):
    """A packed PPO batch for GAE as numpy [R, T] arrays: rewards, values,
    int32 segment ids and bootstraps. Each row holds segments of
    seg_len[0]..seg_len[1] tokens with 0-2 padding tokens between them and
    a padding tail (the segment it meets is cut there). Rewards are a small
    per-token (KL-like) term plus a score at each segment's last token;
    about half the segments are truncated and bootstrap there."""
    seg = np.zeros((R, T), np.int32)
    for r in range(R):
        used = T - int(rng.integers(0, T // 8 + 1))
        t, s = int(rng.integers(0, 3)), 1
        while t < used:
            end = min(t + int(rng.integers(seg_len[0], seg_len[1] + 1)), used)
            seg[r, t:end] = s
            s += 1
            t = end + int(rng.integers(0, 3))
    valid = seg > 0
    nxt = np.concatenate([seg[:, 1:], np.zeros((R, 1), np.int32)], axis=1)
    last = valid & (seg != nxt)
    rew = rng.standard_normal((R, T), np.float32) * np.float32(0.01)
    rew[last] += rng.standard_normal(int(last.sum()), np.float32)
    val = rng.standard_normal((R, T), np.float32) * valid
    boot = np.zeros((R, T), np.float32)
    trunc = last & (rng.random((R, T)) < 0.5)
    boot[trunc] = rng.standard_normal(int(trunc.sum()), np.float32)
    return rew * valid, val, seg, boot


def parity_gae(torch, rng, dev, report, gae_rng):
    """Both GAE entries against their plain versions (the serial scan
    loop; the affine elements, that loop and the masking), two runs of
    each bit-equal, then device time, call time and bound at three
    shapes. The scan's five random cases and its [16, 4096] timing input
    draw from `rng`, the packed batches from `gae_rng`, which keeps the
    later phases' batches those of earlier versions of this script."""
    from areal_tpu_torch.ops.gae import (
        CHUNK, GaePlan, _gae_affine_elems, _packed_gae_kernel, _scan_kernel, gae_plan,
        reference_packed_gae, reference_scan_reverse)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def case(R, T):
        # a is gamma * lam inside a segment and 0 at its end and on padding
        a = np.full((R, T), 0.97 * 0.95, np.float32)
        b = rng.standard_normal((R, T), np.float32)
        for r in range(R):
            ends = rng.choice(np.arange(T), size=min(T, int(rng.integers(1, 7))), replace=False)
            a[r, ends] = 0.0
            tail = int(rng.integers(0, T // 4 + 1))
            if tail:
                a[r, T - tail:] = 0.0
                b[r, T - tail:] = 0.0
        return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)

    errs = {"gae_scan_f32": [], "packed_gae_f32": []}

    def check(kname, label, got, ref, again, zero=None):
        scale = max(1.0, max(r.abs().max().item() for r in ref))
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        zeros = zero is None or all(bool((g[zero] == 0).all()) for g in got)
        log(f"  {kname} {label}: max_abs_err={err:.3e} against scale {scale:.3f} "
            f"(tol {GAE_RTOL} relative); two runs bit-equal: {same}; zeros outside "
            f"segments: {zeros}")
        if not (err <= GAE_RTOL * scale and all(torch.isfinite(g).all() for g in got)
                and same and zeros):
            raise AssertionError(f"{kname} {label} disagrees with its plain version")
        errs[kname].append((err, err / scale))

    for R, T in ((16, 4096), (5, 1000), (3, 5001), (1, 7), (300, 129)):
        a, b = case(R, T)
        check("gae_scan_f32", f"[{R}, {T}] random", [_scan_kernel(a, b)],
              [reference_scan_reverse(a, b)], [_scan_kernel(a, b)])
    # Packed batches: the five shapes with short segments, then gamma =
    # lam = 1 (the PPO default: a = 1, float32 sums over thousands of
    # tokens), few long rows, and a large batch.
    cases = [(R, T, (3, 400), 0.97, 0.95)
             for R, T in ((16, 4096), (5, 1000), (3, 5001), (1, 7), (300, 129))]
    cases += [(8, 16384, (2048, 12288), 1.0, 1.0), (2, 32768, (2048, 24576), 1.0, 0.95),
              (4096, 4096, (64, 3072), 0.97, 0.95)]
    for R, T, seg_len, gamma, lam in cases:
        rew, val, seg, boot = (torch.from_numpy(x).to(dev)
                               for x in gae_batch(gae_rng, R, T, seg_len))
        label = f"[{R}, {T}] segments {seg_len[0]}-{seg_len[1]} gamma {gamma} lam {lam}"
        a, b, _, _ = _gae_affine_elems(rew, val, seg, boot, gamma, lam)
        check("gae_scan_f32", label, [_scan_kernel(a, b)], [reference_scan_reverse(a, b)],
              [_scan_kernel(a, b)])
        check("packed_gae_f32", label, _packed_gae_kernel(rew, val, seg, boot, gamma, lam),
              reference_packed_gae(rew, val, seg, boot, gamma, lam),
              _packed_gae_kernel(rew, val, seg, boot, gamma, lam), zero=seg == 0)
        del rew, val, seg, boot, a, b
        torch.cuda.empty_cache()

    # Timing: the PPO step's shape (the whole batch as 16 rows of 4096),
    # few long rows, a large batch. The plain loop (one serial step a
    # token) is timed at the first only.
    scan_in = case(16, 4096)
    timings = {"gae_scan_f32": [], "packed_gae_f32": []}
    for i, (R, T) in enumerate(GAE_TIMING_SHAPES):
        rew, val, seg, boot = (torch.from_numpy(x).to(dev)
                               for x in gae_batch(gae_rng, R, T, (64, 3072)))
        a, b = scan_in if i == 0 else _gae_affine_elems(rew, val, seg, boot, 0.97, 0.95)[:2]
        plan = gae_plan(R, T, n_sm)
        n = R * T
        for kname, fn, plain, nbytes, flops in (
                ("gae_scan_f32", lambda: _scan_kernel(a, b),
                 lambda: reference_scan_reverse(a, b), 12.0, 2.0),
                ("packed_gae_f32", lambda: _packed_gae_kernel(rew, val, seg, boot, 0.97, 0.95),
                 lambda: reference_packed_gae(rew, val, seg, boot, 0.97, 0.95), 24.0,
                 PACKED_GAE_FLOPS)):
            b_ms, b_by = bound(flops * n, nbytes * n, PEAK_F32_FLOPS)
            t = dict(shape=[R, T], ms=device_ms(fn, ["gae_"], iters=50, per_call=1),
                     call_ms=time_ms(fn, iters=50), bound_ms=b_ms, bound_by=b_by,
                     tile=plan.tile, tiles_per_row=plan.tiles, ctas=plan.ctas)
            if i == 0:
                t["plain_ms"] = time_ms(plain, iters=2, warmup=1)
            timings[kname].append(t)
            log(f"  {kname} timing [{R}, {T}]: kernel {t['ms']:.5f} ms (device), whole call "
                f"{t['call_ms']:.5f} ms (events); bound {b_ms:.5f} ms ({b_by}); "
                f"{plan.tiles} tiles of {plan.tile} a row, {plan.ctas} CTAs"
                + (f"; plain {t['plain_ms']:.1f} ms" if i == 0 else ""))
        del rew, val, seg, boot, a, b
        torch.cuda.empty_cache()

    # Both plan modes at each shape, whatever gae_plan picks there: a whole
    # row a CTA against one-chunk tiles across CTAs, on the same inputs,
    # held to each other within GAE_RTOL.
    modes = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for R, T in GAE_PLAN_SHAPES:
        a = torch.where(torch.rand((R, T), generator=gen, device=dev) < 1e-3, 0.0,
                        0.97 * 0.95).float()
        b = torch.randn((R, T), generator=gen, device=dev)
        seg = (torch.arange(T, device=dev, dtype=torch.int32) // 1500 + 1).expand(R, T)
        seg = torch.where(torch.arange(T, device=dev) < T - T // 16, seg, 0).contiguous()
        chunks = -(-T // CHUNK)
        whole, split = GaePlan(chunks * CHUNK, 1, R), GaePlan(CHUNK, chunks, R * chunks)
        row = dict(shape=[R, T], chosen="whole" if gae_plan(R, T, n_sm) == whole else "split")
        for kname, fn in (
                ("gae_scan_f32", lambda plan: (_scan_kernel(a, b, plan),)),
                ("packed_gae_f32", lambda plan: _packed_gae_kernel(b, a, seg, b, 0.97, 0.95,
                                                                   plan))):
            outs = [fn(whole), fn(split)]
            scale = max(1.0, outs[0][0].abs().max().item())
            err = max((u - w).abs().max().item() for u, w in zip(*outs))
            if not err <= GAE_RTOL * scale:
                raise AssertionError(f"{kname} [{R}, {T}]: the two plan modes differ by {err}")
            row[kname] = dict(
                whole_ms=device_ms(lambda: fn(whole), ["gae_"], iters=30, per_call=1),
                split_ms=device_ms(lambda: fn(split), ["gae_"], iters=30, per_call=1))
            log(f"  {kname} plan modes [{R}, {T}] ({row['chosen']} chosen): whole rows "
                f"{row[kname]['whole_ms']:.5f} ms, split {row[kname]['split_ms']:.5f} ms "
                f"(device); modes agree to {err:.2e}")
        modes.append(row)
        del a, b, seg, outs
        torch.cuda.empty_cache()

    for kname in timings:
        first = timings[kname][0]
        report[kname] = dict(
            name=kname, route="cuda", source="areal_tpu_torch/csrc/gae_scan.cu",
            replaces="areal_tpu/ops/pallas/gae_scan.py:113",
            max_abs_err=max(e for e, _ in errs[kname]),
            max_rel_err=max(r for _, r in errs[kname]), ms=first["ms"],
            call_ms=first["call_ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=None,
            shape="R=16 T=4096 f32", tiles_per_row=first["tiles_per_row"],
            ctas=first["ctas"], timings=timings[kname],
            plan_modes=[dict(shape=m["shape"], chosen=m["chosen"], **m[kname]) for m in modes])


# The decode-path matmuls of R1-Distill-Qwen-1.5B as the decode step
# launches them: (names, K, parts), the projections that read the same
# input packed side by side (one launch for wq|wk|wv, one for w_gate|w_up),
# each launched once a layer (28) and the head once; M is the step's rows,
# 16 slots plain and 80 at draft length 4, 37 a ragged count.
W8A16_SHAPES = ((("wq", "wk", "wv"), 1536, (1536, 256, 256)), (("wo",), 1536, (1536,)),
                (("w_gate", "w_up"), 1536, (8960, 8960)), (("w_down",), 8960, (1536,)),
                (("head",), 1536, (151936,)))
# Held to the plain version but not timed: one projection alone (wk, the
# smallest); gpt2's head, whose 50257 columns (a row stride of 50257
# bytes) only the packed layout makes legal for 16-byte copies; a ragged
# K, whose activation rows the wrapper zero-pads to 16 bytes for TMA.
W8A16_PARITY_SHAPES = ((("wk",), 1536, (256,)), (("gpt2 head",), 768, (50257,)),
                       (("ragged",), 100, (40,)))
W8A16_M = (16, 37, 80)
# Held to the plain version on the grouped wq|wk|wv launch only, not
# timed: with W8A16_M's 16, 48 and 80 they reach every row-block width the
# kernel is built for (ops/wquant.MB_WIDTHS), which the engine takes with
# more slots or other draft lengths; 300 rows run two row blocks of 160.
W8A16_WIDE_M = (32, 64, 96, 128, 160, 192, 256, 300)
W8A16_TIMED_M = (16, 80)
MODEL_LAYERS = 28
# The kernel against its plain version, both bf16 with float32 sums in
# another order: every output row within W8A16_RTOL of that row's largest
# plain value (about 2.5 bf16 ulps there).
W8A16_RTOL = 1e-2
# Timed calls cycle through copies of the weight that together pass
# W8A16_RING_BYTES, so each call finds its weight out of the 50 MB L2, as
# a decode step does (it streams every layer's weights once).
W8A16_RING_BYTES = 128 << 20
# The sweep (--w8a16-sweep): ring stages (even: a slot feeds one of the
# two consumer warpgroups), chunks a stage (the K depth a stage carries, 64
# each) and CTAs an SM, around the defaults of ops/wquant (STAGES, CPS,
# CTAS_PER_SM).
W8A16_SWEEP = dict(stages=(2, 4, 6, 8), cps=(1, 2, 4), ctas_per_sm=(1, 2))


class Ring:
    """Each call returns the next of `items`, cyclically."""

    def __init__(self, items):
        self.items, self.i = list(items), 0

    def __call__(self):
        self.i = (self.i + 1) % len(self.items)
        return self.items[self.i]


def w8a16_case(torch, dev, gen, K, parts):
    """(bf16 weight [K, N], int8 codes, scales, packed) of one shape, drawn
    on the card; the codes and scales of each part are quantized apart, as
    the decode tree does."""
    from areal_tpu_torch.ops.wquant import pack_weights, quantize_weight

    ws = [(torch.randn((K, n), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
          for n in parts]
    pairs = [quantize_weight(w) for w in ws]
    w = torch.cat(ws, dim=1)
    wq = torch.cat([q for q, _ in pairs], dim=1)
    s = torch.cat([x for _, x in pairs])
    return w, wq, s, pack_weights(pairs)


def parity_w8a16(torch, dev, report, case_rng):
    """The W8A16 kernel against its plain version (dequantize, cuBLAS,
    scale) at the decode path's launches (W8A16_SHAPES, grouped as the
    decode step launches them) and W8A16_PARITY_SHAPES, M in W8A16_M (and
    W8A16_WIDE_M on wq|wk|wv): the per-row error within W8A16_RTOL, two
    runs bit-equal. At M = 16 and 80
    it times the kernel (device time of its launch), the plain version,
    torch.matmul on the unquantized bf16 weight (one call a launch, on the
    grouped projections' concatenated weights too, where the bf16 decode
    path makes one a projection; device time) and torch._weight_int8pack_mm on the transposed
    codes (the same function in one PyTorch call; device time, or the
    error it raised), beside the bound (int8 weight, scales, activations
    and output once / 3.35 TB/s), and sums them over one decode step at the
    model's 28 layers plus the head. Each timed call reads its weight from
    a ring of copies larger than the L2 (W8A16_RING_BYTES). Weights and
    activations are drawn on the card from a generator seeded from
    `case_rng`."""
    from areal_tpu_torch.ops.wquant import PackedW8, _qmat_plain, w8a16_matmul

    gen = torch.Generator(device=dev).manual_seed(int(case_rng.integers(1 << 31)))
    bf = torch.bfloat16
    errs, rels, shapes = [], [], []
    int8pack_error = None
    step = {M: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, library_int8_ms=0.0, flops=0.0,
                    bytes=0.0) for M in W8A16_TIMED_M}
    for names, K, parts in W8A16_SHAPES + W8A16_PARITY_SHAPES:
        timed = (names, K, parts) in W8A16_SHAPES
        w, wq, s, pw = w8a16_case(torch, dev, gen, K, parts)
        N = pw.N
        rings = None
        for M in W8A16_M + (W8A16_WIDE_M if names == ("wq", "wk", "wv") else ()):
            a = torch.randn((M, K), generator=gen, device=dev).to(bf)
            out = w8a16_matmul(a, pw)
            ref = _qmat_plain(a, wq, s, bf)
            err, rel = row_errors(out, ref)
            same = torch.equal(out, w8a16_matmul(a, pw))
            log(f"  w8a16_matmul_bf16 {'|'.join(names)} M={M} K={K} N={N}: max_abs_err="
                f"{err:.3e} max_row_rel_err={rel:.3e} (tol {W8A16_RTOL}); two runs bit-equal: "
                f"{same}")
            if not (rel <= W8A16_RTOL and same and torch.isfinite(out.float()).all()):
                raise AssertionError(f"w8a16_matmul_bf16 M={M} K={K} N={N} disagrees with its "
                                     "plain version, or two runs differ")
            errs.append(err)
            rels.append(rel)
            if not timed or M not in W8A16_TIMED_M:
                continue
            nbytes = K * N + 4 * N + 2 * M * K + 2 * M * N
            flops = 2.0 * M * N * K
            b_ms, b_by = bound(flops, nbytes)
            if rings is None:
                wt = wq.t().contiguous()
                rings = dict(
                    q=Ring([pw] + [PackedW8(pw.codes.clone(), pw.scale, K, pw.parts)
                                   for _ in range(W8A16_RING_BYTES // (K * N))]),
                    w=Ring([w] + [w.clone() for _ in range(W8A16_RING_BYTES // (2 * K * N))]),
                    t=Ring([wt] + [wt.clone() for _ in range(W8A16_RING_BYTES // (K * N))]),
                    u=Ring([wq] + [wq.clone() for _ in range(W8A16_RING_BYTES // (K * N))]))
                s_bf = s.to(bf)
            row = dict(names=list(names), M=M, K=K, N=N, bound_ms=b_ms, bound_by=b_by,
                       ms=device_ms(lambda: w8a16_matmul(a, rings["q"]()), ("w8a16",),
                                    iters=30, per_call=1),
                       plain_ms=time_ms(lambda: _qmat_plain(a, rings["u"](), s, bf), iters=10),
                       library_ms=device_ms(lambda: torch.matmul(a, rings["w"]()), iters=30,
                                            per_call="auto"),
                       library_int8_ms=None)
            if int8pack_error is None:
                try:
                    got = torch._weight_int8pack_mm(a, wt, s_bf)
                    row["library_int8_ms"] = device_ms(
                        lambda: torch._weight_int8pack_mm(a, rings["t"](), s_bf), iters=30,
                        per_call="auto")
                    row["library_int8_max_row_rel_err"] = row_errors(got, ref)[1]
                except Exception as e:  # noqa: BLE001 - the library call's own refusal
                    int8pack_error = f"{type(e).__name__}: {str(e)[:200]}"
                    log(f"  torch._weight_int8pack_mm raised on {dev}: {int8pack_error}")
            shapes.append(row)
            times = MODEL_LAYERS if names != ("head",) else 1
            for k in ("ms", "plain_ms", "library_ms"):
                step[M][k] += times * row[k]
            if row["library_int8_ms"] is not None:
                step[M]["library_int8_ms"] += times * row["library_int8_ms"]
            step[M]["flops"] += times * flops
            step[M]["bytes"] += times * nbytes
            int8 = (f"{row['library_int8_ms']:.4f} ms (device)" if row["library_int8_ms"]
                    is not None else "raised")
            log(f"  w8a16_matmul_bf16 timing {'|'.join(names)} M={M} K={K} N={N}: kernel "
                f"{row['ms']:.4f} ms (device), plain {row['plain_ms']:.4f} ms, bf16 "
                f"torch.matmul {row['library_ms']:.4f} ms (device), torch._weight_int8pack_mm "
                f"{int8}; bound {b_ms:.4f} ms ({b_by}); weights cold in L2")
        del w, wq, s, pw, a, out, ref, rings
        torch.cuda.empty_cache()
    for M, t in step.items():
        t["bound_ms"], t["bound_by"] = bound(t["flops"], t["bytes"])
        if int8pack_error is not None:
            t["library_int8_ms"] = None
        int8 = f"{t['library_int8_ms']:.3f} ms" if t["library_int8_ms"] is not None else "raised"
        log(f"  w8a16_matmul_bf16 one decode step at {MODEL_LAYERS} layers + head, M={M} "
            f"({4 * MODEL_LAYERS + 1} launches): kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bf16 torch.matmul {t['library_ms']:.3f} ms, "
            f"torch._weight_int8pack_mm {int8}; bound {t['bound_ms']:.3f} ms ({t['bound_by']})")
    main = step[80]
    report["w8a16_matmul_bf16"] = dict(
        name="w8a16_matmul_bf16", route="cuda", source="areal_tpu_torch/csrc/w8a16_matmul.cu",
        replaces="areal_tpu/ops/wquant.py:44",
        note=("no TPU kernel: the reference's qmat quantized branch (wquant.py:44-51) is an "
              "XLA fusion; the numbers are one decode step's W8A16 matmuls at 28 layers plus "
              "the head, M=80 rows (16 slots, draft length 4), launched as the decode path "
              "launches them (wq|wk|wv and w_gate|w_up grouped); library_ms is bf16 "
              "torch.matmul on the unquantized weights, grouped as the kernel's launches "
              "(the bf16 decode path makes one matmul a projection), library_int8_ms "
              "torch._weight_int8pack_mm on the transposed codes"),
        max_abs_err=max(errs), max_row_rel_err=max(rels), ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], library_int8_ms=main["library_int8_ms"],
        library_int8_error=int8pack_error,
        shape="decode step, 28 layers + head, M=80",
        step_m16={k: step[16][k] for k in ("ms", "plain_ms", "library_ms", "library_int8_ms",
                                           "bound_ms")},
        shapes=shapes)


def sweep_w8a16(torch, dev, case_rng):
    """--w8a16-sweep: one decode step's W8A16 time (W8A16_SHAPES at 28
    layers + head, weights cold in L2) at M = 16 and 80 for each ring shape
    and CTAs an SM of W8A16_SWEEP, each call checked against the default
    shape's output (bit-equal where the plan is the same); a shape whose
    A slice leaves no room is logged and skipped."""
    import itertools

    from areal_tpu_torch import kernels
    from areal_tpu_torch.ops.wquant import PackedW8, w8a16_matmul, w8a16_plan

    gen = torch.Generator(device=dev).manual_seed(int(case_rng.integers(1 << 31)))
    bf = torch.bfloat16
    configs = list(itertools.product(*W8A16_SWEEP.values()))
    n_sm = kernels.sm_count(dev.index or 0)
    step = {}
    for names, K, parts in W8A16_SHAPES:
        _, wq, s, pw = w8a16_case(torch, dev, gen, K, parts)
        N = pw.N
        ring = Ring([pw] + [PackedW8(pw.codes.clone(), pw.scale, K, pw.parts)
                            for _ in range(W8A16_RING_BYTES // (K * N))])
        times = MODEL_LAYERS if names != ("head",) else 1
        for M in W8A16_TIMED_M:
            a = torch.randn((M, K), generator=gen, device=dev).to(bf)
            want = w8a16_matmul(a, pw)
            cells = []
            for st, cps, ctas in configs:
                try:
                    plan = w8a16_plan(M, K, N, n_sm, st, cps, ctas)
                except ValueError:
                    cells.append(f"{st}/{cps}/{ctas}: no room")
                    continue
                kw = dict(stages=st, cps=cps, ctas_per_sm=ctas)
                got = w8a16_matmul(a, pw, **kw)
                if not row_errors(got, want)[1] <= W8A16_RTOL:
                    raise AssertionError(f"sweep {st}/{cps}/{ctas} M={M} K={K} N={N} disagrees")
                ms = device_ms(lambda: w8a16_matmul(a, ring(), **kw), ("w8a16",), iters=20,
                               per_call=1)
                step[(st, cps, ctas, M)] = step.get((st, cps, ctas, M), 0.0) + times * ms
                cells.append(f"{st}/{cps}/{ctas}: {ms:.4f} (s{plan.splits} g{plan.groups})")
            log(f"  sweep {'|'.join(names)} M={M} (stages/cps/ctas: ms, splits, groups): "
                + ", ".join(cells))
        del wq, s, pw, ring, a, want
        torch.cuda.empty_cache()
    rows = [dict(stages=k[0], cps=k[1], ctas_per_sm=k[2], M=k[3], step_ms=v)
            for k, v in sorted(step.items())]
    for M in W8A16_TIMED_M:
        best = min((r for r in rows if r["M"] == M), key=lambda r: r["step_ms"])
        log(f"  sweep one decode step M={M}: " + ", ".join(
            f"{r['stages']}/{r['cps']}/{r['ctas_per_sm']} {r['step_ms']:.3f} ms"
            for r in rows if r["M"] == M) + f"; best {best['stages']}/{best['cps']}/"
            f"{best['ctas_per_sm']}")
    return rows


# ----------------------------------------------------------------------
# Phases 3-5: serving
# ----------------------------------------------------------------------


def run_requests(engine, reqs, timeout=900.0):
    results, done = {}, threading.Event()
    lock = threading.Lock()

    def cb(res):
        with lock:
            results[res.qid] = res
            if len(results) == len(reqs):
                done.set()

    t0 = time.perf_counter()
    for r in reqs:
        r.done_cb = cb
        engine.submit(r)
    if not done.wait(timeout):
        raise TimeoutError(f"only {len(results)}/{len(reqs)} requests finished")
    wall = time.perf_counter() - t0
    errs = [r.error for r in results.values() if r.error]
    if errs:
        raise RuntimeError(f"serving failed: {errs[0]}")
    return results, wall


def mixed_requests(rng, vocab):
    from areal_tpu_torch.engine.serving import GenRequest

    plens = [64, 200, 3000, 1500, 700, 2600, 90, 1024, 1100, 400, 2048, 333,
             128, 900, 1800, 2999]
    reqs = []
    for i, n in enumerate(plens):
        mode = i % 4
        reqs.append(GenRequest(
            qid=f"mix{i}", input_ids=rng.integers(0, vocab, size=n).tolist(),
            max_new_tokens=int(rng.integers(64, 257)),
            greedy=mode == 0,
            temperature=1.0 if mode in (0, 1) else 0.7,
            top_p=0.9 if mode == 2 else 1.0,
            top_k=40 if mode == 3 else -1,
        ))
    twin = rng.integers(0, vocab, size=512).tolist()
    for j in range(2):
        reqs.append(GenRequest(qid=f"twin{j}", input_ids=list(twin),
                               max_new_tokens=96, greedy=True))
    return reqs


def check_results(torch, engine, cfg, params, reqs, results):
    """Every request finished with valid ids and logprobs <= 0; the twin
    greedy prompts agree; greedy outputs agree with a teacher-forced
    forward over prompt + output (teacher_forced_check)."""
    V = cfg.vocab_size
    for r in reqs:
        res = results[r.qid]
        ids, lps = res.output_ids, res.output_logprobs
        if not (1 <= len(ids) <= r.max_new_tokens and len(lps) == len(ids)):
            raise AssertionError(f"{r.qid}: {len(ids)} tokens for budget {r.max_new_tokens}")
        if not all(0 <= t < V for t in ids):
            raise AssertionError(f"{r.qid}: token id out of range")
        if not all(math.isfinite(x) and x <= 0.0 for x in lps):
            raise AssertionError(f"{r.qid}: logprob not finite or > 0")
    if results["twin0"].output_ids != results["twin1"].output_ids:
        raise AssertionError("identical greedy prompts gave different tokens")
    teacher_forced_check(torch, engine.device, cfg, params, reqs, results)


def teacher_forced_logp(torch, dev, cfg, params, prompt, out):
    """log_softmax of a forward over prompt + out[:-1] at the positions
    that predict each of `out` ([len(out), V] float32)."""
    from areal_tpu_torch.models.transformer import forward

    seq = list(prompt) + list(out)[:-1]
    ids = torch.tensor([seq], dtype=torch.int32, device=dev)
    pos = torch.arange(len(seq), dtype=torch.int32, device=dev)[None]
    with torch.inference_mode():
        logits = forward(params, cfg, ids, torch.ones_like(ids), pos,
                         device=dev)[0, len(prompt) - 1:]
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite teacher-forced logits")
    return torch.log_softmax(logits.float(), dim=-1)


def teacher_forced_check(torch, dev, cfg, params, reqs, results, agree_min=0.95,
                         med_max=0.05, greedy_only=True, label="teacher-forced check"):
    """Outputs against a teacher-forced forward over prompt + output (the
    packed prefill path, a different computation from the paged decode that
    produced them): at least `agree_min` of the greedy tokens at the
    forward's argmax (within 0.1 nats), and the median |logprob - the
    forward's| at most `med_max`. Sampled requests count toward the median
    only, and only with greedy_only=False; prompts over 1100 tokens are
    skipped."""
    diffs, agree, n_tok = [], 0, 0
    for r in reqs:
        if (greedy_only and not r.greedy) or len(r.input_ids) > 1100:
            continue
        res = results[r.qid]
        logp = teacher_forced_logp(torch, dev, cfg, params, r.input_ids, res.output_ids)
        out = torch.tensor(res.output_ids, device=dev)
        lp_tf = logp.gather(-1, out[:, None])[:, 0].cpu().numpy()
        diffs.extend(np.abs(lp_tf - np.asarray(res.output_logprobs)).tolist())
        if r.greedy:
            # a greedy token is the forward's argmax, or within 0.1 nats of it
            gap = (logp.max(dim=-1).values - logp.gather(-1, out[:, None])[:, 0]).cpu().numpy()
            agree += int((gap <= 0.1).sum())
            n_tok += len(out)
    med = float(np.median(diffs))
    log(f"  {label}: {agree}/{n_tok} greedy tokens at the forward's argmax "
        f"(within 0.1 nats); median |logprob diff| {med:.4f}")
    if agree < agree_min * n_tok or med > med_max:
        raise AssertionError(f"{label}: outputs disagree with the teacher-forced forward")
    return dict(agree=agree, greedy_tokens=n_tok, median_logprob_diff=med)


def _kernel_class(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_attn_fwd_bf16"
    if "flash_bwd_dq_kernel" in name:
        return "flash_attn_bwd_dq_bf16"
    if "flash_bwd_dkv_kernel" in name:
        return "flash_attn_bwd_dkv_bf16"
    if "packed_gae_kernel" in name:
        return "packed_gae_f32"
    if "gae_scan_kernel" in name:
        return "gae_scan_f32"
    if "paged_split_kernel" in name or "paged_combine_kernel" in name:
        return "paged decode, decode steps"
    if "paged_chunk_kernel" in name:
        return "paged decode, chunk steps"
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "sort" in low or "topk" in low:
        return "sampling sort/topk"
    return "other (elementwise, norms, copies, ...)"


def profile_window(torch, fn):
    """Run fn() (which returns its wall seconds) under torch.profiler;
    return the device busy time by kernel class and the device idle share
    of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = fn()
        torch.cuda.synchronize()
    # Device rows only (kernels, memcpys, memsets): an operator's row
    # repeats the time of the kernels it launched.
    by_class, by_name, busy_us = {}, {}, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us <= 0:
            continue
        busy_us += us
        c = _kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
        by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    busy_ms = busy_us / 1e3
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1.0 - busy_ms / (wall * 1e3)),
                device_ms_by_class=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
                top_kernels=[[k[:100], v] for k, v in
                             sorted(by_name.items(), key=lambda kv: -kv[1])[:16]])


def serve_phase(torch, rng, dev, cfg, params, kv_cache_dtype, profiled=False):
    from areal_tpu_torch import kernels
    from areal_tpu_torch.engine.serving import GenRequest, ServingEngine

    engine = ServingEngine(
        cfg, params, max_batch_size=16, max_seq_len=4096, decode_block_steps=16,
        page_size=128, prefill_chunk=1024, prefill_max_batch=8,
        eos_token_id=151643, seed=int(rng.integers(1 << 30)),
        kv_cache_dtype=kv_cache_dtype, device=dev,
    )
    engine.start()
    try:
        # Warm-up (cuBLAS handles, allocator) outside the counted run.
        run_requests(engine, [GenRequest(qid="warm", input_ids=[1] * 64,
                                         max_new_tokens=17, greedy=True)])
        reqs = mixed_requests(rng, cfg.vocab_size)
        kernels.reset_launches()
        results, wall = run_requests(engine, reqs)
        counts = dict(kernels.launches)
        n_prompt = sum(len(r.input_ids) for r in reqs)
        n_out = sum(len(res.output_ids) for res in results.values())
        log(f"  mixed run: {len(reqs)} requests, {n_prompt} prompt tokens, {n_out} "
            f"output tokens in {wall:.2f} s ({n_out / wall:.1f} output tok/s); "
            f"launches {counts}")
        check_results(torch, engine, cfg, params, reqs, results)
        # Prefill throughput and TTFT: 16 prompts of 1024 tokens, 1 new token.
        burst = [GenRequest(qid=f"ttft{i}", input_ids=rng.integers(0, cfg.vocab_size, 1024).tolist(),
                            max_new_tokens=1) for i in range(16)]
        res_b, wall_b = run_requests(engine, burst)
        ttft = sorted(r.latency for r in res_b.values())
        # Decode throughput: 16 short prompts decode 128 tokens each past
        # the first; the prefill time of the same prompts is subtracted.
        prompts = [rng.integers(0, cfg.vocab_size, 128).tolist() for _ in range(16)]
        _, wall_p = run_requests(engine, [GenRequest(qid=f"p{i}", input_ids=p, max_new_tokens=1)
                                          for i, p in enumerate(prompts)])
        _, wall_d = run_requests(engine, [GenRequest(
            qid=f"d{i}", input_ids=p, max_new_tokens=129, min_new_tokens=129, greedy=True)
            for i, p in enumerate(prompts)])
        stats = dict(
            requests=len(reqs), prompt_tokens=n_prompt, output_tokens=n_out,
            mixed_wall_s=wall, mixed_output_tok_s=n_out / wall,
            prefill_tok_s=16 * 1024 / wall_b,
            ttft_p50_ms=1e3 * ttft[len(ttft) // 2], ttft_max_ms=1e3 * ttft[-1],
            decode_tok_s=16 * 128 / max(wall_d - wall_p, 1e-9),
            launches=counts,
        )
        log(f"  prefill {stats['prefill_tok_s']:.0f} tok/s (16 x 1024), TTFT p50 "
            f"{stats['ttft_p50_ms']:.1f} ms max {stats['ttft_max_ms']:.1f} ms; decode "
            f"{stats['decode_tok_s']:.1f} tok/s (16 slots x 128 tokens)")
        if not profiled:
            return stats
        # Where the time goes: profiled windows of prefill only (16 x 1024
        # prompts, 1 new token), short-context decode (the decode run
        # above) and long-context decode (16 x 3000-token prompts, 32 new
        # tokens; chunked prefill included).
        V = cfg.vocab_size
        long_prompts = [rng.integers(0, V, 3000).tolist() for _ in range(16)]
        windows = {
            "prefill_16x1024": lambda: [GenRequest(
                qid=f"wp{i}", input_ids=rng.integers(0, V, 1024).tolist(),
                max_new_tokens=1) for i in range(16)],
            "decode_16x128": lambda: [GenRequest(
                qid=f"wd{i}", input_ids=p, max_new_tokens=129, min_new_tokens=129,
                greedy=True) for i, p in enumerate(prompts)],
            "long_16x3000": lambda: [GenRequest(
                qid=f"wl{i}", input_ids=p, max_new_tokens=33, min_new_tokens=33,
                greedy=True) for i, p in enumerate(long_prompts)],
        }
        stats["profile"] = {}
        for wname, fn in windows.items():
            prof = profile_window(torch, lambda: run_requests(engine, fn())[1])
            stats["profile"][wname] = prof
            top = ", ".join(f"{k} {v:.1f} ms" for k, v in prof["device_ms_by_class"].items())
            log(f"  profile {wname}: wall {prof['wall_ms']:.1f} ms, device busy "
                f"{prof['device_busy_ms']:.1f} ms (idle share "
                f"{prof['device_idle_share']:.3f}); {top}")
        return stats
    finally:
        engine.stop()


def interrupt_phase(torch, rng, dev, cfg, params):
    from areal_tpu_torch import kernels
    from areal_tpu_torch.engine.serving import GenRequest, ServingEngine

    engine = ServingEngine(cfg, params, max_batch_size=4, max_seq_len=4096,
                           decode_block_steps=16, page_size=128, prefill_chunk=1024,
                           eos_token_id=None, seed=7, device=dev)
    engine.start()
    try:
        results, done = {}, threading.Event()

        def cb(res):
            results[res.qid] = res
            if len(results) == 4:
                done.set()

        kernels.reset_launches()
        for i in range(4):
            engine.submit(GenRequest(qid=f"long{i}", input_ids=rng.integers(0, cfg.vocab_size, 256).tolist(),
                                     max_new_tokens=3000, done_cb=cb))
        t0 = time.monotonic()
        while engine.decode_blocks < 4 and time.monotonic() - t0 < 300:
            time.sleep(0.05)
        new_params = {k: v for k, v in params.items()}
        new_params["final_norm"] = {"weight": params["final_norm"]["weight"] * 1.01}
        engine.update_params(new_params, allow_interrupt=True)
        if not done.wait(300):
            raise TimeoutError("interrupted requests did not return")
        for res in results.values():
            if not (res.interrupted and res.no_eos and 0 < len(res.output_ids) < 3000
                    and res.version_start == 0):
                raise AssertionError(f"bad interrupted result {res.qid}: "
                                     f"interrupted={res.interrupted} n={len(res.output_ids)}")
        t0 = time.monotonic()
        while engine.version != 1 and time.monotonic() - t0 < 60:
            time.sleep(0.05)
        after, _ = run_requests(engine, [GenRequest(qid="after", input_ids=[5, 6, 7],
                                                    max_new_tokens=8)])
        if engine.version != 1 or after["after"].version_start != 1:
            raise AssertionError("weight update did not go live")
        counts = dict(kernels.launches)
        for k in ("flash_attn_fwd_bf16", "paged_decode_bf16"):
            if counts[k] <= 0:
                raise AssertionError(f"interrupt: kernel {k} was not launched")
        lens = sorted(len(r.output_ids) for r in results.values())
        log(f"  interrupted 4 requests at {lens} tokens; version {engine.version}; "
            f"launches {counts}")
        return dict(partial_tokens=lens, launches=counts)
    finally:
        engine.stop()


# ----------------------------------------------------------------------
# Phase 7: the generation server over HTTP
# ----------------------------------------------------------------------

STOP_TOKEN = 151643  # R1-Distill-Qwen's end-of-sentence id: the server has no tokenizer


def http_call(url, path, payload=None, headers=None, timeout=900.0):
    """(status, headers, parsed body) of one request to the server; a
    POST when `payload` is given. /metrics parses to {name: value}."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data,
                                 {"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, hdrs, body = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        status, hdrs, body = e.code, dict(e.headers), e.read()
    if path == "/metrics":
        return status, hdrs, dict(line.split(" ", 1) for line in body.decode().splitlines())
    return status, hdrs, json.loads(body)


def generate_body(req, priority=None):
    """A GenRequest as the /generate JSON a rollout worker sends."""
    body = {"qid": req.qid, "input_ids": list(req.input_ids), "gconfig": {
        "max_new_tokens": req.max_new_tokens, "min_new_tokens": req.min_new_tokens,
        "greedy": req.greedy, "temperature": req.temperature, "top_p": req.top_p,
        "top_k": req.top_k, "stop_token_ids": list(req.stop_token_ids)}}
    if priority is not None:
        body["priority"] = priority
    return body


def http_wave(url, bodies):
    """POST every body from its own client thread, all released together;
    returns ({qid: response}, wall seconds). Every answer must be a 200
    with the reference's response keys; each response also carries
    `http_s`, its round trip as the client saw it less the engine's
    `latency` (submit to result): the time the request spent in HTTP and
    in the server's handler."""
    from types import SimpleNamespace

    keys = {"qid", "output_ids", "output_logprobs", "no_eos", "interrupted",
            "version_start", "version_end", "latency"}
    out, errors = {}, []
    start = threading.Barrier(len(bodies) + 1)

    def client(body):
        start.wait()
        t0 = time.monotonic()
        try:
            status, _, reply = http_call(url, "/generate", body)
        except Exception as e:  # reported below, with the qid
            status, reply = None, repr(e)
        if status != 200 or set(reply) != keys:
            errors.append(f"{body['qid']}: {status} {reply}")
        else:
            out[body["qid"]] = SimpleNamespace(
                **reply, http_s=time.monotonic() - t0 - reply["latency"])

    threads = [threading.Thread(target=client, args=(b,)) for b in bodies]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"/generate failed: {errors[:3]}")
    return out, wall


def perturbed(torch, params, seed):
    """A second seeded param set: each leaf times (1 + 0.01 N(0, 1)),
    drawn on the params' device."""
    gen = torch.Generator(device=next(iter(params["final_norm"].values())).device)
    gen.manual_seed(seed)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        noise = torch.randn(x.shape, generator=gen, device=x.device, dtype=torch.float32)
        return (x.float() * (1.0 + 0.01 * noise)).to(x.dtype)

    return leaf(params)


def http_phase(torch, rng, dev, cfg, seed, card):
    """The port's GenerationServer in process, at the serving phases'
    configuration plus the qid prefix cache and token-budget admission,
    driven through HTTP: a mixed wave from 18 client threads, six
    continuations that must hit the prefix cache, the same wave through
    the engine alone, greedy requests equal over HTTP and direct, a
    weight update from a raw dump mid-wave (interrupted results, the
    resubmissions on version 1, a stale retry), and admission shedding."""
    import dataclasses
    import shutil
    import tempfile

    from areal_tpu_torch import kernels
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.system_api import GenerationServerConfig
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.engine.serving import GenRequest
    from areal_tpu_torch.system.generation_server import GenerationServer
    from areal_tpu_torch.system.weight_transfer import dump_raw_params

    tmp = tempfile.mkdtemp(prefix="chip_smoke_http_")
    name_resolve.reconfigure("nfs", record_root=os.path.join(tmp, "name_resolve"))
    # An experiment name of this run's own: a weight update looks in
    # /dev/shm/areal_tpu/<experiment>/<trial>/<role> before the dump it is
    # given, and must not find another run's dump there.
    exp = os.path.basename(tmp)
    gcfg = GenerationServerConfig(
        experiment_name=exp, trial_name="http", server_index=0,
        model=ModelAbstraction("tpu_transformer", args=dict(config=dataclasses.asdict(cfg))),
        max_concurrent_requests=16, max_seq_len=4096, kv_page_size=128,
        decode_block_steps=16, prefill_chunk=1024, prefix_cache_tokens=65536,
        prefill_token_budget=8192, warm_on_start=True, seed=seed, device=str(dev))
    server = GenerationServer()
    t0 = time.perf_counter()
    server.configure(gcfg, experiment_name=gcfg.experiment_name, trial_name=gcfg.trial_name,
                     worker_name=gcfg.worker_name)
    run = threading.Thread(target=server.run, daemon=True)
    run.start()
    stats = dict(card=card)
    try:
        url = name_resolve.get(names.gen_server_url(exp, "http", "0"))
        engine = server.engine
        # /health first. It also builds urllib's opener (an SSL context
        # among its handlers, ~0.5 s with 18 threads racing to build it),
        # which the wave's first requests would otherwise pay inside
        # their round trips, as a long-lived client does not.
        status, _, health = http_call(url, "/health")
        if status != 200 or health != {"status": "ok", "version": 0, "role": "unified"}:
            raise AssertionError(f"http: /health answered {status} {health}")
        log(f"  server at {url} in {time.perf_counter() - t0:.1f} s (seeded random weights, "
            f"warm_on_start)")

        # The mixed wave over HTTP, the prefix-cache continuations after it,
        # the launches of each counted from 0. Nothing else launches a
        # kernel until both counts are read: the checks come after.
        reqs = mixed_requests(rng, cfg.vocab_size)
        for r in reqs:
            r.stop_token_ids = (STOP_TOKEN,)
        engine.latency_snapshot(reset=True)
        kernels.reset_launches()
        results, wall = http_wave(url, [generate_body(r) for r in reqs])
        counts_wave = dict(kernels.launches)
        _, _, m_wave = http_call(url, "/metrics")
        cont = [r for r in reqs if r.qid in ("mix1", "mix4", "mix9", "mix12", "mix13", "twin0")]
        cont_bodies = []
        for r in cont:
            fresh = rng.integers(0, cfg.vocab_size, size=32).tolist()
            c = GenRequest(qid=r.qid, input_ids=list(r.input_ids) + results[r.qid].output_ids
                           + fresh, max_new_tokens=32, greedy=True,
                           stop_token_ids=(STOP_TOKEN,))
            cont_bodies.append(generate_body(c, priority=0))
        kernels.reset_launches()
        _, cont_wall = http_wave(url, cont_bodies)
        counts_cont = dict(kernels.launches)
        counts = {k: counts_wave.get(k, 0) + counts_cont.get(k, 0)
                  for k in set(counts_wave) | set(counts_cont)}
        _, _, m = http_call(url, "/metrics")
        hits = float(m["areal:prefix_cache_hits"])
        n_prompt = sum(len(r.input_ids) for r in reqs)
        n_out = sum(len(res.output_ids) for res in results.values())
        http_ms = sorted(1e3 * res.http_s for res in results.values())
        check_results(torch, engine, engine.cfg, engine.params, reqs, results)
        log(f"  http wave: {len(reqs)} requests, {n_prompt} prompt tokens, {n_out} output "
            f"tokens in {wall:.2f} s ({n_out / wall:.1f} output tok/s); TTFT p50 "
            f"{m_wave['areal:ttft_p50_ms']} p99 {m_wave['areal:ttft_p99_ms']} ms, ITL p50 "
            f"{m_wave['areal:itl_p50_ms']} p99 {m_wave['areal:itl_p99_ms']} ms (/metrics "
            f"bucket edges); HTTP and handler time a request (round trip less engine "
            f"latency) median {http_ms[len(http_ms) // 2]:.1f} ms, max {http_ms[-1]:.1f} ms; "
            f"{card}")
        log(f"  continuations: {len(cont)} in {cont_wall:.2f} s; prefix_cache_hits {hits}, "
            f"prefix_tokens_reused {m['areal:prefix_tokens_reused']}; launches through the "
            f"server: wave {counts_wave}, continuations {counts_cont}")
        if hits < 6:
            raise AssertionError(f"http: prefix_cache_hits {hits} < 6 after the continuations")
        for k in ("flash_attn_fwd_bf16", "paged_decode_bf16"):
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"http: kernel {k} was not launched through the server")

        # The same wave through the engine alone (new qids, no cache hits),
        # its launches and latencies apart.
        direct = [dataclasses.replace(r, qid=r.qid + "-direct", done_cb=None) for r in reqs]
        engine.latency_snapshot(reset=True)
        kernels.reset_launches()
        res_d, wall_d = run_requests(engine, direct)
        counts_d = dict(kernels.launches)
        snap_d = engine.latency_snapshot()
        n_out_d = sum(len(x.output_ids) for x in res_d.values())
        log(f"  engine alone, same wave: {n_out_d} output tokens in {wall_d:.2f} s "
            f"({n_out_d / wall_d:.1f} output tok/s; HTTP wall {wall:.2f} s); TTFT p50 "
            f"{snap_d['ttft_p50_ms']} p99 {snap_d['ttft_p99_ms']} ms, ITL p50 "
            f"{snap_d['itl_p50_ms']} p99 {snap_d['itl_p99_ms']} ms; launches {counts_d}")

        # Greedy requests one at a time: over HTTP and direct, bit-equal.
        for i, n in enumerate((300, 700)):
            r = GenRequest(qid=f"eq{i}", input_ids=rng.integers(0, cfg.vocab_size, n).tolist(),
                           max_new_tokens=64, greedy=True, stop_token_ids=(STOP_TOKEN,))
            status, _, over_http = http_call(url, "/generate", generate_body(r))
            alone, _ = run_requests(engine, [dataclasses.replace(r, qid=f"eq{i}-direct")])
            if status != 200 or over_http["output_ids"] != alone[f"eq{i}-direct"].output_ids:
                raise AssertionError(f"http: greedy eq{i} differs over HTTP and direct")
        log("  greedy requests over HTTP and through the engine alone: tokens bit-equal")

        # A weight update from a raw dump while a wave of 16 decodes.
        t1 = time.perf_counter()
        dump_dir = os.path.join(tmp, "param_realloc", "actor")
        new_params = perturbed(torch, engine.params, seed + 1)
        dump_s = dump_raw_params(new_params, dump_dir, version=1)
        del new_params
        torch.cuda.empty_cache()
        log(f"  raw dump of a second seeded param set: {dump_s:.1f} s")
        wave = [GenRequest(qid=f"upd{i}", input_ids=rng.integers(0, cfg.vocab_size, 256).tolist(),
                           max_new_tokens=2048, min_new_tokens=2048, greedy=True,
                           stop_token_ids=(STOP_TOKEN,)) for i in range(16)]
        box = {}
        waver = threading.Thread(target=lambda: box.update(
            zip(("res", "wall"), http_wave(url, [generate_body(r) for r in wave]))))
        waver.start()
        deadline = time.monotonic() + 300
        while float(http_call(url, "/metrics")[2]["areal:num_running_reqs"]) < 16:
            if time.monotonic() > deadline:
                raise TimeoutError("http: the update wave never ran 16 requests")
            time.sleep(0.05)
        status, _, upd = http_call(url, "/update_weights_from_disk", {
            "model_path": dump_dir, "allow_interrupt": True, "version": 1})
        waver.join()
        # The phase writes its dump to disk only, so the disk is the source.
        if status != 200 or not upd.get("success") or upd["source"] != "disk_raw":
            raise AssertionError(f"http: weight update failed: {status} {upd}")
        partial = box["res"]
        if not all(x.interrupted and 0 < len(x.output_ids) < 2048 and x.version_start == 0
                   for x in partial.values()):
            raise AssertionError("http: the wave was not interrupted by the update")
        # The partial-rollout protocol: resubmit prompt + partial output.
        resub, _ = http_wave(url, [generate_body(GenRequest(
            qid=r.qid, input_ids=list(r.input_ids) + partial[r.qid].output_ids,
            max_new_tokens=16, greedy=True, stop_token_ids=(STOP_TOKEN,)), priority=0)
            for r in wave])
        if not all(x.version_start == x.version_end == 1 and not x.interrupted
                   for x in resub.values()):
            raise AssertionError("http: resubmissions did not run on version 1")
        _, _, m = http_call(url, "/metrics")
        if m["areal:weight_version"] != "1.0":
            raise AssertionError(f"http: weight_version {m['areal:weight_version']}")
        status, _, stale = http_call(url, "/update_weights_from_disk", {
            "model_path": dump_dir, "allow_interrupt": True, "version": 1})
        if status != 200 or stale.get("stale") is not True:
            raise AssertionError(f"http: the retry of version 1 was not stale: {stale}")
        log(f"  weight update mid-wave: source {upd['source']}, load_s {upd['load_s']:.3f}, "
            f"last_weight_stage_s {m['areal:last_weight_stage_s']}, last_weight_swap_s "
            f"{m['areal:last_weight_swap_s']}; 16 interrupted at "
            f"{sorted(len(x.output_ids) for x in partial.values())} tokens (version_end "
            f"{sorted({x.version_end for x in partial.values()})}), resubmitted on version 1; "
            f"stale retry recognized; {time.perf_counter() - t1:.1f} s; {card}")

        # Admission shedding.
        http_call(url, "/configure", {"max_queue_depth": 0})
        status, hdrs, shed = http_call(url, "/generate", generate_body(reqs[0]))
        http_call(url, "/configure", {"max_queue_depth": None})
        if status != 429 or "Retry-After" not in hdrs or shed.get("error") != "overloaded":
            raise AssertionError(f"http: max_queue_depth=0 did not shed: {status} {shed}")
        log(f"  shed: 429, Retry-After {hdrs['Retry-After']}")
        stats.update(
            requests=len(reqs), prompt_tokens=n_prompt, output_tokens=n_out, wave_wall_s=wall,
            wave_output_tok_s=n_out / wall, wave_launches=counts_wave,
            continuation_launches=counts_cont,
            http_ms_median=http_ms[len(http_ms) // 2], http_ms_max=http_ms[-1],
            engine_alone_wall_s=wall_d, engine_alone_output_tokens=n_out_d,
            engine_alone_output_tok_s=n_out_d / wall_d, engine_alone_launches=counts_d,
            engine_alone_ttft_p50_ms=snap_d["ttft_p50_ms"],
            engine_alone_ttft_p99_ms=snap_d["ttft_p99_ms"],
            engine_alone_itl_p50_ms=snap_d["itl_p50_ms"],
            engine_alone_itl_p99_ms=snap_d["itl_p99_ms"],
            ttft_p50_ms=float(m_wave["areal:ttft_p50_ms"]),
            ttft_p99_ms=float(m_wave["areal:ttft_p99_ms"]),
            itl_p50_ms=float(m_wave["areal:itl_p50_ms"]),
            itl_p99_ms=float(m_wave["areal:itl_p99_ms"]),
            prefix_cache_hits=hits, continuation_wall_s=cont_wall, load_s=upd["load_s"],
            dump_s=dump_s, last_weight_stage_s=float(m["areal:last_weight_stage_s"]),
            last_weight_swap_s=float(m["areal:last_weight_swap_s"]), launches=counts)
        return stats
    finally:
        server.exit()
        run.join(timeout=120)
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 6: speculative decoding and int8 decode weights
# ----------------------------------------------------------------------

# The spec phase at real size: the serving phases' engine (16 slots x 4096
# tokens, 128-token pages, 16-step blocks, 1024-token chunks), 16 greedy
# requests of 256 new tokens (half a 64-token span repeated 4-8 times, half
# fresh prompts of 256-512 tokens), draft length 4 over bigrams; 128
# sampled tokens a request in leg (b); 8 requests of 64 tokens over HTTP,
# then 32 after the weight update. A rehearsal on the CPU passes SPEC_TINY.
SPEC_SIZES = dict(slots=16, max_seq_len=4096, page=128, chunk=1024, block=16, n_req=16,
                  new=256, span=64, reps=(4, 8), fresh=(256, 512), sampled_new=128, draft=4,
                  ngram=2, server_req=8, server_new=64, upd_req=2, upd_new=32)
SPEC_TINY = dict(slots=4, max_seq_len=256, page=8, chunk=64, block=4, n_req=4, new=24,
                 span=6, reps=(3, 5), fresh=(8, 16), sampled_new=12, draft=3, ngram=2,
                 server_req=2, server_new=12, upd_req=1, upd_new=8)
# Where the speculative engine parts from the plain one (bf16 rows of
# another batch shape round differently), the two tokens' teacher-forced
# top-2 gap must be within SPEC_GAP nats: a near tie, not a wrong token.
SPEC_GAP = 0.1
# Leg (c): the int8 pool, speculation and int8 weights against a
# teacher-forced forward on the dequantized decode weights (w_q * s):
# share of greedy tokens at its argmax (within 0.1 nats) and the median
# |logprob difference|.
SPEC_C_AGREE = 0.95
SPEC_C_MED = 0.05


def dequantized_tree(cfg, params, qparams):
    """(cfg, params) whose decode-path weights are the int8 tree's w_q * s
    in the compute dtype, the head untied (a teacher-forced forward on what
    the int8 decode path multiplies by)."""
    from areal_tpu_torch.ops.wquant import unpack_decode_tree

    cdt = params["final_norm"]["weight"].dtype
    qparams = unpack_decode_tree(qparams)  # a card's tree holds them packed

    def deq(tree):
        if isinstance(tree, dict):
            return {k: deq(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            wq, s = tree
            return (wq.float() * s[..., None, :]).to(cdt)
        return tree

    out = dict(params, layers=deq(qparams["layers"]), head={"weight": deq(qparams["head_q"])})
    return dataclasses.replace(cfg, tied_embeddings=False), out


def spec_phase(torch, rng, dev, cfg, params, seed, card, sizes=SPEC_SIZES):
    """N-gram speculative decoding and int8 decode weights through the
    engine and the server, at the serving phases' width, depth and params:
    (a) 16 greedy requests through a plain and a speculative engine: the
    speculative outputs pass the teacher-forced check, each request's
    tokens equal the plain engine's up to the first step where they part
    (the top-2 gap there within SPEC_GAP), the yield is above 1 token a
    step and paged_decode_bf16 launched; (b) sampled requests (temperature
    1, top-p 0.9) on the speculative engine: valid ids, logprobs within
    0.05 (median) of the forward's; (c) the int8 pool, speculation and int8
    weights in one engine: first tokens equal the bf16 engine's (prefill is
    unquantized), greedy tokens pass the teacher-forced check on the
    dequantized decode weights, w8a16_matmul_bf16 and paged_decode_int8
    launched; then a GenerationServer with speculation and int8 weights
    takes an HTTP wave (/metrics: emitted tokens > active steps) and a
    weight update from a raw dump of perturbed() params, after which its
    greedy tokens equal an engine's built on those params (the int8 copy
    was rebuilt). Decode tok/s of four engines (plain bf16, int8 weights,
    speculative, speculative with int8 weights) each from a run less the
    prefill-only run of the same prompts."""
    import shutil
    import tempfile

    from areal_tpu_torch import kernels
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.system_api import GenerationServerConfig
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.engine.serving import GenRequest, ServingEngine
    from areal_tpu_torch.system.generation_server import GenerationServer
    from areal_tpu_torch.system.weight_transfer import dump_raw_params

    sz = sizes
    on_card = dev.type == "cuda"
    V = cfg.vocab_size
    n = sz["n_req"]
    prompts = []
    for i in range(n):
        if i % 2 == 0:  # n-gram rich: one span repeated
            span = rng.integers(0, V, sz["span"]).tolist()
            prompts.append(span * int(rng.integers(sz["reps"][0], sz["reps"][1] + 1)))
        else:
            prompts.append(rng.integers(0, V, int(rng.integers(*sz["fresh"]))).tolist())
    spec_kw = dict(speculative_draft_len=sz["draft"], speculative_ngram=sz["ngram"])
    launches = {}

    def add(counts):
        for k, v in (counts or {}).items():
            launches[k] = launches.get(k, 0) + v

    def make(engine_params=params, **kw):
        eng = ServingEngine(cfg, engine_params, max_batch_size=sz["slots"],
                            max_seq_len=sz["max_seq_len"], decode_block_steps=sz["block"],
                            page_size=sz["page"], prefill_chunk=sz["chunk"], eos_token_id=None,
                            seed=seed, device=dev, **kw)
        eng.start()
        return eng

    def greedy(tag, new, which=None):
        return [GenRequest(qid=f"{tag}{i}", input_ids=list(p), max_new_tokens=new, greedy=True)
                for i, p in enumerate(prompts) if which is None or i in which]

    def drive(eng, tag, counted=False):
        """Warm-up, the prompts' prefill alone, then the greedy run:
        (results, decode tok/s, yield of the run, its launches)."""
        run_requests(eng, [GenRequest(qid=f"{tag}-warm", input_ids=[1] * 64,
                                      max_new_tokens=2 * sz["block"], greedy=True)])
        _, wall_p = run_requests(eng, greedy(f"{tag}-p", 1))
        m0 = eng.metrics()
        if counted:
            kernels.reset_launches()
        res, wall = run_requests(eng, greedy(tag, sz["new"]))
        counts = dict(kernels.launches) if counted else None
        m1 = eng.metrics()
        steps = m1["spec_active_steps"] - m0["spec_active_steps"]
        yld = (m1["spec_emitted_tokens"] - m0["spec_emitted_tokens"]) / steps if steps else 1.0
        return res, n * (sz["new"] - 1) / max(wall - wall_p, 1e-9), yld, counts

    stats = dict(card=card)
    t0 = time.perf_counter()
    # (a) greedy: plain against speculative.
    eng = make()
    try:
        res_plain, tok_plain, _, _ = drive(eng, "a0-")
    finally:
        eng.stop()
    eng = make(**spec_kw)
    try:
        res_spec, tok_spec, yld_spec, counts_a = drive(eng, "a1-", counted=True)
        add(counts_a)
        tf_a = teacher_forced_check(torch, dev, cfg, params, greedy("a1-", sz["new"]), res_spec,
                                    label="leg (a) teacher-forced check, speculative outputs")
        parted = []
        for i, p in enumerate(prompts):
            a_ids, b_ids = res_plain[f"a0-{i}"].output_ids, res_spec[f"a1-{i}"].output_ids
            if len(a_ids) != sz["new"] or len(b_ids) != sz["new"]:
                raise AssertionError(f"spec: request {i} stopped early without an EOS")
            j = next((k for k, (x, y) in enumerate(zip(a_ids, b_ids)) if x != y), None)
            if j is None:
                continue
            top2 = teacher_forced_logp(torch, dev, cfg, params, p, b_ids[:j + 1])[-1].topk(2)
            gap = float(top2.values[0] - top2.values[1])
            parted.append(dict(request=i, step=j, top2_gap=gap))
            if gap > SPEC_GAP:
                raise AssertionError(f"spec: request {i} parts from the plain engine at token "
                                     f"{j} with a top-2 gap of {gap:.4f} nats > {SPEC_GAP}")
        log(f"  leg (a) greedy, {n} requests x {sz['new']} tokens: plain {tok_plain:.1f} "
            f"decode tok/s, speculative {tok_spec:.1f} decode tok/s, "
            f"{yld_spec:.3f} tokens a step; {len(parted)} of {n} part from the plain engine "
            f"({[(x['request'], x['step'], round(x['top2_gap'], 4)) for x in parted]}: "
            f"request, token, top-2 gap); launches {counts_a}; {card}")
        if yld_spec <= 1.0:
            raise AssertionError(f"spec: {yld_spec} tokens a step: no draft was accepted")
        if on_card and counts_a["paged_decode_bf16"] <= 0:
            raise AssertionError("spec: paged_decode_bf16 was not launched")
        # (b) sampled, on the same engine.
        sreqs = [GenRequest(qid=f"b{i}", input_ids=list(p), max_new_tokens=sz["sampled_new"],
                            temperature=1.0, top_p=0.9) for i, p in enumerate(prompts)]
        m_a = eng.metrics()
        res_b, _ = run_requests(eng, sreqs)
        for r in sreqs:
            ids, lps = res_b[r.qid].output_ids, res_b[r.qid].output_logprobs
            if not (1 <= len(ids) <= r.max_new_tokens and len(lps) == len(ids)
                    and all(0 <= t < V for t in ids)
                    and all(math.isfinite(x) and x <= 0.0 for x in lps)):
                raise AssertionError(f"spec: sampled {r.qid} gave invalid ids or logprobs")
        tf_b = teacher_forced_check(torch, dev, cfg, params, sreqs, res_b, agree_min=0.0,
                                    greedy_only=False, label="leg (b) sampled, teacher-forced")
        m_b = eng.metrics()
        steps_b = m_b["spec_active_steps"] - m_a["spec_active_steps"]
        yld_b = (m_b["spec_emitted_tokens"] - m_a["spec_emitted_tokens"]) / max(steps_b, 1.0)
        log(f"  leg (b) sampled, {n} requests x {sz['sampled_new']} tokens: {yld_b:.3f} tokens "
            f"a step")
    finally:
        eng.stop()

    # (c) int8 weights: alone, with speculation, and with the int8 pool too.
    eng = make(decode_weight_dtype="int8")
    try:
        _, tok_w, _, _ = drive(eng, "c0-")
    finally:
        eng.stop()
    eng = make(decode_weight_dtype="int8", **spec_kw)
    try:
        _, tok_sw, yld_sw, _ = drive(eng, "c1-")
    finally:
        eng.stop()
    eng = make(decode_weight_dtype="int8", kv_cache_dtype="int8", **spec_kw)
    try:
        res_c, tok_c, yld_c, counts_c = drive(eng, "c2-", counted=True)
        add(counts_c)
        cfg_d, deq = dequantized_tree(cfg, params, eng._qparams)
    finally:
        eng.stop()
    firsts = [(res_c[f"c2-{i}"].output_ids[0], res_plain[f"a0-{i}"].output_ids[0])
              for i in range(n)]
    if any(x != y for x, y in firsts):
        raise AssertionError(f"spec: leg (c)'s first tokens differ from the bf16 engine's "
                             f"(prefill is unquantized): {firsts}")
    tf_c = teacher_forced_check(torch, dev, cfg_d, deq, greedy("c2-", sz["new"]), res_c,
                                agree_min=SPEC_C_AGREE, med_max=SPEC_C_MED,
                                label="leg (c) teacher-forced check on w_q * s")
    del deq
    log(f"  leg (c) int8 pool + speculation + int8 weights: {tok_c:.1f} decode tok/s, "
        f"{yld_c:.3f} tokens a step, first tokens equal the bf16 engine's; launches "
        f"{counts_c}; {card}")
    if on_card and (counts_c["w8a16_matmul_bf16"] <= 0 or counts_c["paged_decode_int8"] <= 0):
        raise AssertionError("spec: w8a16_matmul_bf16 or paged_decode_int8 was not launched")
    decode = dict(bf16=tok_plain, int8_weights=tok_w, spec=tok_spec, spec_int8_weights=tok_sw)
    log(f"  decode tok/s ({n} x {sz['new']} greedy tokens, bf16 pool): plain bf16 "
        f"{tok_plain:.1f}, int8 weights {tok_w:.1f}, speculative {tok_spec:.1f} "
        f"({yld_spec:.3f} tokens a step), speculative with int8 weights {tok_sw:.1f} "
        f"({yld_sw:.3f}); {card}")
    stats.update(
        greedy=dict(plain_tok_s=tok_plain, spec_tok_s=tok_spec, spec_tokens_per_step=yld_spec,
                    parted=parted, teacher_forced=tf_a),
        sampled=dict(teacher_forced=tf_b, spec_tokens_per_step=yld_b),
        decode_tok_s=decode,
        spec_tokens_per_step=dict(spec=yld_spec, spec_int8_weights=yld_sw, all_three=yld_c),
        all_three=dict(decode_tok_s=tok_c, spec_tokens_per_step=yld_c, teacher_forced=tf_c),
        engines_s=time.perf_counter() - t0)

    # The server: an HTTP wave, /metrics, a weight update.
    t1 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_spec_")
    name_resolve.reconfigure("nfs", record_root=os.path.join(tmp, "name_resolve"))
    exp = os.path.basename(tmp)
    gcfg = GenerationServerConfig(
        experiment_name=exp, trial_name="spec", server_index=0,
        model=ModelAbstraction("tpu_transformer", args=dict(config=dataclasses.asdict(cfg))),
        max_concurrent_requests=sz["slots"], max_seq_len=sz["max_seq_len"],
        kv_page_size=sz["page"], decode_block_steps=sz["block"], prefill_chunk=sz["chunk"],
        speculative_draft_len=sz["draft"], speculative_ngram=sz["ngram"],
        decode_weight_dtype="int8", seed=seed, device=str(dev))
    server = GenerationServer()
    server.configure(gcfg, experiment_name=gcfg.experiment_name, trial_name=gcfg.trial_name,
                     worker_name=gcfg.worker_name)
    run = threading.Thread(target=server.run, daemon=True)
    run.start()
    try:
        url = name_resolve.get(names.gen_server_url(exp, "spec", "0"))
        wave = greedy("s", sz["server_new"], which=set(range(0, 2 * sz["server_req"], 2)))
        kernels.reset_launches()
        _, wall_s = http_wave(url, [generate_body(r) for r in wave])
        counts_s = dict(kernels.launches)
        add(counts_s)
        _, _, m = http_call(url, "/metrics")
        emitted, steps = float(m["areal:spec_emitted_tokens"]), float(m["areal:spec_active_steps"])
        log(f"  server wave: {len(wave)} requests x {sz['server_new']} tokens in {wall_s:.2f} s; "
            f"/metrics areal:spec_emitted_tokens {emitted}, areal:spec_active_steps {steps}, "
            f"areal:spec_tokens_per_step {m['areal:spec_tokens_per_step']}; launches {counts_s}")
        if not emitted > steps > 0:
            raise AssertionError(f"spec: the server's /metrics read {emitted} tokens over "
                                 f"{steps} steps")
        if on_card and counts_s["w8a16_matmul_bf16"] <= 0:
            raise AssertionError("spec: w8a16_matmul_bf16 was not launched through the server")
        new_params = perturbed(torch, server.engine.params, seed + 1)
        dump_dir = os.path.join(tmp, "param_realloc", "actor")
        dump_s = dump_raw_params(new_params, dump_dir, version=1)
        status, _, upd = http_call(url, "/update_weights_from_disk", {
            "model_path": dump_dir, "allow_interrupt": True, "version": 1})
        if status != 200 or not upd.get("success"):
            raise AssertionError(f"spec: the weight update failed: {status} {upd}")
        after = greedy("u", sz["upd_new"], which=set(range(sz["upd_req"])))
        got = {}
        for r in after:
            status, _, body = http_call(url, "/generate", generate_body(r))
            if status != 200 or body["version_start"] != 1:
                raise AssertionError(f"spec: /generate after the update: {status} {body}")
            got[r.qid] = body["output_ids"]
    finally:
        server.exit()
        run.join(timeout=120)
    try:
        eng = make(new_params, decode_weight_dtype="int8", **spec_kw)
        try:
            want = {}
            for r in after:
                res, _ = run_requests(eng, [dataclasses.replace(r, done_cb=None)])
                want[r.qid] = res[r.qid].output_ids
        finally:
            eng.stop()
        log(f"  server after the update (dump {dump_s:.1f} s, load_s {upd['load_s']:.3f}): "
            f"greedy tokens of {len(after)} requests equal an engine's on the new params: "
            f"{got == want}; server leg {time.perf_counter() - t1:.1f} s")
        if got != want:
            raise AssertionError("spec: after the weight update the server's tokens do not "
                                 "follow the new weights (a stale int8 copy?)")
    finally:
        del new_params
        shutil.rmtree(tmp, ignore_errors=True)
    stats.update(server=dict(spec_emitted_tokens=emitted, spec_active_steps=steps,
                             wave_s=wall_s, dump_s=dump_s, load_s=upd["load_s"],
                             follows_new_weights=True),
                 server_s=time.perf_counter() - t1, launches=launches)
    return stats


# ----------------------------------------------------------------------
# Phases 8-9: training
# ----------------------------------------------------------------------


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def leaf_paths(tree, prefix=""):
    """Names of a param tree's leaves in `optimizer.tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    return [prefix.lstrip("/")]


def _draw(rng, lo_hi) -> int:
    return int(rng.integers(lo_hi[0], lo_hi[1] + 1))


def rollout_sample(rng, sizes, vocab):
    """A seeded rollout batch as the rollout workers hand it to the
    trainer: `n_prompts` prompts with `group` responses each, prompt mask,
    per-sequence rewards (a good and a bad answer alternate) and no-EOS
    flags (two sequences were cut at the length limit)."""
    from areal_tpu_torch.api.data_api import SequenceSample

    n_prompts, group = sizes["n_prompts"], sizes["group"]
    ids, pms, group_lens = [], [], []
    for _ in range(n_prompts):
        prompt = rng.integers(0, vocab, size=_draw(rng, sizes["prompt"]))
        lens = []
        for _ in range(group):
            resp = rng.integers(0, vocab, size=_draw(rng, sizes["response"]))
            ids.append(np.concatenate([prompt, resp]))
            pms.append(np.concatenate([np.ones(len(prompt), np.int64),
                                       np.zeros(len(resp), np.int64)]))
            lens.append(len(prompt) + len(resp))
        group_lens.append(lens)
    n_seqs = n_prompts * group
    no_eos = np.zeros(n_seqs, np.float32)
    no_eos[[1, n_seqs - 2]] = 1.0
    per_seq = [[1] * group for _ in range(n_prompts)]
    return SequenceSample(
        ids=[f"prompt{i}" for i in range(n_prompts)],
        keys={"packed_input_ids", "prompt_mask", "seq_no_eos_mask", "rewards"},
        data={"packed_input_ids": np.concatenate(ids), "prompt_mask": np.concatenate(pms),
              "seq_no_eos_mask": no_eos,
              "rewards": np.tile([5.0, -5.0], n_seqs // 2 + 1)[:n_seqs].astype(np.float32)},
        seqlens={"packed_input_ids": group_lens, "prompt_mask": group_lens,
                 "seq_no_eos_mask": per_seq, "rewards": per_seq},
        metadata={"version_start": [0] * n_prompts, "version_end": [0] * n_prompts},
    )


def sft_sample(rng, n_seqs, sizes, vocab):
    from areal_tpu_torch.api.data_api import SequenceSample

    plens = [_draw(rng, sizes["prompt"]) for _ in range(n_seqs)]
    rlens = [_draw(rng, sizes["response"]) for _ in range(n_seqs)]
    lens = [p + r for p, r in zip(plens, rlens)]
    pm = np.concatenate([np.arange(n) < p for n, p in zip(lens, plens)]).astype(np.int64)
    return SequenceSample.from_default(
        ids=[f"sft{i}" for i in range(n_seqs)], seqlens=lens,
        data={"packed_input_ids": rng.integers(0, vocab, size=sum(lens)), "prompt_mask": pm})


def grad_phase(torch, rng, dev, cfg, seed):
    """Gradients of the SFT loss at full width and 2 layers: the kernel
    path (flash forward and backward kernels) against the plain attention,
    both on `dev`, leaf by leaf."""
    import dataclasses

    from areal_tpu_torch import kernels
    from areal_tpu_torch.engine.optimizer import tree_leaves
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
    from areal_tpu_torch.interfaces.sft import sft_loss_weight, sft_row_loss
    from areal_tpu_torch.models import transformer
    from areal_tpu_torch.ops.attention import reference_packed_attention

    cfg2 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32")
    params = transformer.init_params(cfg2, seed=seed, device=dev)
    engine = TorchTrainEngine(cfg2, params, remat="full", row_len_multiple=1024,
                              max_row_len=1024, device=dev)
    sample = sft_sample(rng, 6, dict(prompt=(16, 128), response=(64, 512)), cfg2.vocab_size)
    _, rows_np = engine._build_rows(sample)
    rows = engine._device_rows(rows_np)
    denom = sft_loss_weight(sample)
    leaves = tree_leaves(engine.params)

    def loss_and_grads():
        loss, _ = sft_row_loss(engine._model_out(rows, "logprobs", "full"), rows)
        grads = torch.autograd.grad(loss / denom, leaves)
        return loss.item() / denom, grads

    kernels.reset_launches()
    loss_k, g_k = loss_and_grads()
    counts = dict(kernels.launches)
    # The plain path: the model's attention entry swapped for the plain
    # version for this one call.
    kernel_entry = transformer.packed_attention
    transformer.packed_attention = reference_packed_attention
    try:
        loss_p, g_p = loss_and_grads()
    finally:
        transformer.packed_attention = kernel_entry
    sync(torch, dev)
    worst = {}
    for name, a, b in zip(leaf_paths(engine.params), g_k, g_p):
        top = b.float().abs().max().item()
        worst[name] = (a.float() - b.float()).abs().max().item() / max(top, 1e-30)
        if not torch.isfinite(a).all() or worst[name] > LEAF_TOL:
            raise AssertionError(f"grad: leaf {name} differs by {worst[name]:.3e} of its "
                                 f"largest reference value (tol {LEAF_TOL})")
    if abs(loss_k - loss_p) > 1e-2 * abs(loss_p):
        raise AssertionError(f"grad: loss {loss_k} through the kernels, {loss_p} plain")
    if dev.type == "cuda":
        for k in ("flash_attn_fwd_bf16", "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16"):
            if counts[k] <= 0:
                raise AssertionError(f"grad: kernel {k} was not launched")
    name, val = max(worst.items(), key=lambda kv: kv[1])
    log(f"  rows {tuple(rows['input_ids'].shape)}, {int(denom)} loss tokens: loss "
        f"{loss_k:.5f} (kernels) vs {loss_p:.5f} (plain); {len(worst)} leaves, worst "
        f"{name} at {val:.3e} of max|ref| (tol {LEAF_TOL}); launches {counts}")
    return dict(loss_kernels=loss_k, loss_plain=loss_p, worst_leaf=name, worst_rel=val,
                per_leaf=worst, launches=counts)


def train_phase(torch, rng, dev, cfg, seed, sizes=TRAIN_SIZES):
    """PPO actor inference and train_step, then SFT steps, through the
    interfaces and a TorchTrainEngine with float32 params."""
    import dataclasses

    from areal_tpu_torch import kernels
    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.model_api import Model, ModelName, make_interface
    from areal_tpu_torch.engine.optimizer import OptimizerConfig
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
    from areal_tpu_torch.interfaces import ppo, sft  # noqa: F401  (register the interfaces)
    from areal_tpu_torch.models.transformer import count_params, init_params

    cfg = dataclasses.replace(cfg, param_dtype="float32")
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = TorchTrainEngine(
        cfg, init_params(cfg, seed=seed, device=dev),
        optimizer_config=OptimizerConfig(lr=5e-5, warmup_steps_proportion=0.0),
        total_train_steps=100, remat="full", row_len_multiple=sizes["row_len"],
        max_row_len=sizes["row_len"], device=dev)
    sync(torch, dev)
    log(f"  engine: {cfg.n_layers} layers, {count_params(engine.params) / 1e9:.3f} B params "
        f"({cfg.param_dtype} params and moments, {cfg.compute_dtype} compute, seeded "
        f"random) in {time.perf_counter() - t0:.1f} s")
    model = Model(name=ModelName("actor"), module=engine, tokenizer=None)
    actor = make_interface("ppo_actor", n_minibatches=sizes["n_minibatches"],
                           gae_lambda=0.95)
    mb_spec = MicroBatchSpec(max_tokens_per_mb=sizes["max_tokens_per_mb"])
    sample = rollout_sample(rng, sizes, cfg.vocab_size)
    n_tok = sample.total_seqlen()
    # Rows each minibatch packs into: the flash forward's cost follows the
    # rows (it skips no tile under the diagonal), the backward's the tiles
    # that each sequence covers.
    mb_rows = [engine._build_rows(mb)[0].n_rows for mb in
               sample.split(MicroBatchSpec(n_mbs=sizes["n_minibatches"]))[0]]
    probe = engine.params["layers"]["attn"]["wq"]
    before = probe.detach()[0, :8, :8].clone()

    kernels.reset_launches()
    t0 = time.perf_counter()
    behav = actor.inference(model, sample, mb_spec)
    sync(torch, dev)
    t_inf = time.perf_counter() - t0
    lp = behav.data["logprobs"]
    if not np.isfinite(lp).all() or lp.max() > 0:
        raise AssertionError("train: behaviour logprobs not finite or > 0")
    sl = [list(x) for x in sample.seqlens["packed_input_ids"]]
    noise = rng.standard_normal(lp.shape).astype(np.float32) * 0.01
    sample.update_(SequenceSample(
        ids=list(sample.ids), keys={"packed_logprobs", "ref_logprobs"},
        data={"packed_logprobs": lp, "ref_logprobs": lp + noise},
        seqlens={"packed_logprobs": sl, "ref_logprobs": sl}))

    per_minibatch = []
    inner = engine.train_batch

    def recording_train_batch(*args, **kwargs):
        per_minibatch.append(inner(*args, **kwargs))
        return per_minibatch[-1]

    engine.train_batch = recording_train_batch  # to read each minibatch's stats
    t0 = time.perf_counter()
    try:
        stats = actor.train_step(model, sample, mb_spec)
    finally:
        del engine.train_batch
    sync(torch, dev)
    t_ppo = time.perf_counter() - t0
    first = per_minibatch[0]
    log(f"  ppo: {n_tok} tokens in {len(sl) * sizes['group']} sequences; inference "
        f"{t_inf:.2f} s ({n_tok / t_inf:.0f} tok/s); train_step {t_ppo:.2f} s "
        f"({n_tok / t_ppo:.0f} tok/s), {len(per_minibatch)} minibatches of "
        f"{[int(s['ppo_actor/n_mbs']) for s in per_minibatch]} micro-batches and {mb_rows} "
        f"rows of {sizes['row_len']}; first minibatch "
        f"importance_weight {first['ppo_actor/importance_weight']:.6f} clip_ratio "
        f"{first['ppo_actor/clip_ratio']:.2e}; loss {stats['ppo_actor/loss']:.5f} grad_norm "
        f"{stats['ppo_actor/grad_norm']:.4f} adv_mean {stats['ppo_actor/adv_mean']:.4f}")
    bad = [k for k, v in stats.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"train: non-finite stats {bad}")
    if not all(s["ppo_actor/grad_norm"] > 0 for s in per_minibatch):
        raise AssertionError("train: a minibatch had grad norm 0")
    if (abs(first["ppo_actor/importance_weight"] - 1.0) > 1e-3
            or abs(first["ppo_actor/clip_ratio"]) > 1e-3):
        raise AssertionError("train: the first minibatch is not on-policy: importance weight "
                             f"{first['ppo_actor/importance_weight']}, clip ratio "
                             f"{first['ppo_actor/clip_ratio']}")
    if len(per_minibatch) != sizes["n_minibatches"] or model.version != 1 \
            or engine.optimizer.count != sizes["n_minibatches"]:
        raise AssertionError("train: expected one optimizer update per minibatch and "
                             "one version step")
    if torch.equal(before, probe.detach()[0, :8, :8]):
        raise AssertionError("train: parameters did not change")

    sft_itf = make_interface("sft")
    batch = sft_sample(rng, sizes["sft_seqs"], sizes, cfg.vocab_size)
    sft_tok = batch.total_seqlen()
    sft_rows = engine._build_rows(batch)[0].n_rows
    sft_stats, sft_walls = [], []
    for _ in range(sizes["sft_steps"]):
        t0 = time.perf_counter()
        sft_stats.append(sft_itf.train_step(model, batch, mb_spec))
        sync(torch, dev)
        sft_walls.append(time.perf_counter() - t0)
    counts = dict(kernels.launches)
    losses = [s["sft/loss"] for s in sft_stats]
    log(f"  sft: {sizes['sft_steps']} steps on {sft_tok} tokens in {sft_rows} rows: loss "
        f"{losses}, grad_norm "
        f"{[round(s['sft/grad_norm'], 4) for s in sft_stats]}, step wall "
        f"{[round(w, 2) for w in sft_walls]} s ({sft_tok / min(sft_walls):.0f} tok/s best); "
        f"launches {counts}")
    if not all(math.isfinite(v) for s in sft_stats for v in s.values()):
        raise AssertionError("train: non-finite SFT stats")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: SFT loss did not fall: {losses}")
    if model.version != 1 + sizes["sft_steps"]:
        raise AssertionError("train: version did not advance with the SFT steps")
    if on_card:
        for k in ("flash_attn_fwd_bf16", "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16",
                  "packed_gae_f32"):
            if counts[k] <= 0:
                raise AssertionError(f"train: kernel {k} was not launched")
    out = dict(
        tokens=n_tok, inference_s=t_inf, inference_tok_s=n_tok / t_inf,
        train_step_s=t_ppo, train_step_tok_s=n_tok / t_ppo, ppo_stats=stats,
        ppo_minibatches=per_minibatch, ppo_minibatch_rows=mb_rows, sft_tokens=sft_tok,
        sft_rows=sft_rows, sft_losses=losses,
        sft_step_s=sft_walls, sft_tok_s=sft_tok / min(sft_walls), launches=counts)
    if on_card:
        # Where the time goes: one more SFT train_batch under the profiler.
        def one_step():
            t0 = time.perf_counter()
            sft_itf.train_step(model, batch, mb_spec)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        prof = profile_window(torch, one_step)
        out["profile"] = {"sft_train_batch": prof}
        top = ", ".join(f"{k} {v:.1f} ms" for k, v in prof["device_ms_by_class"].items())
        log(f"  profile sft train_batch ({sft_tok} tokens): wall {prof['wall_ms']:.1f} ms, "
            f"device busy {prof['device_busy_ms']:.1f} ms (idle share "
            f"{prof['device_idle_share']:.3f}); {top}")
        for name, ms in prof["top_kernels"]:
            log(f"    {ms:8.1f} ms  {name}")
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"  peak device memory {out['peak_memory_gb']:.2f} GB")
    return out


# ----------------------------------------------------------------------
# Phase 10: the worker system
# ----------------------------------------------------------------------

WORKER_STEPS = 2
# The workers phase's depth, cut from the model's 28 layers to keep the
# default run near half its time limit, from 7 to 4 when the agentic
# phase joined.
WORKERS_LAYERS = 4
WORKERS_TIMEOUT_S = 600.0
# The realloc dump's update from init against an in-process replay's, per
# leaf: ||(dump - init) - (replay - init)|| / ||replay - init||. Readings
# on the H100 (PERF.md, PR 7 run W2): the dump 0 on every leaf (the same
# kernels on the same inputs), the params from before the last step (a
# stale dump) at least 0.44. The limit leaves room for a library call
# whose order of reduction differs between processes, and none for a
# stale or untrained dump.
WORKERS_UPDATE_RTOL = 0.01


# Every loop phase at one depth draws the same seeded weights
# (init_params(cfg, seed)): the first draws and writes them as an HF
# directory once a run, and each phase links those files into its own.
_HF_WEIGHTS = {}


def seeded_hf_dir(torch, cfg, seed, dev, hf_dir):
    """config.json and model.safetensors of ``init_params(cfg, seed)`` in
    bf16, put into ``hf_dir``. Returns the seconds it took: the draw and
    the write for the run's first phase of this configuration, the links
    for the others."""
    import atexit
    import shutil
    import tempfile

    from areal_tpu_torch.models.hf import save_hf_model
    from areal_tpu_torch.models.transformer import init_params

    t0 = time.perf_counter()
    key = (repr(cfg), seed)
    src = _HF_WEIGHTS.get(key)
    if src is None:
        src = tempfile.mkdtemp(prefix="chip_smoke_hf_")
        atexit.register(shutil.rmtree, src, ignore_errors=True)
        params = init_params(cfg, seed=seed, device=dev, dtype=torch.bfloat16)
        save_hf_model(src, cfg, params, "qwen2")
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        _HF_WEIGHTS[key] = src
    os.makedirs(hf_dir, exist_ok=True)
    for name in os.listdir(src):
        try:
            os.link(os.path.join(src, name), os.path.join(hf_dir, name))
        except OSError:
            shutil.copy(os.path.join(src, name), os.path.join(hf_dir, name))
    return time.perf_counter() - t0


def trajectories(rng, sizes, vocab, n_steps):
    """`n_steps` PPO batches as a rollout worker pushes them: one
    trajectory a prompt (its `group` answers), with rewards and no-EOS
    flags (rollout_sample's batch, split by prompt) and behaviour
    logprobs on the response positions near -log(vocab), what a model of
    random weights gives random tokens."""
    from areal_tpu_torch.api.data_api import SequenceSample

    out = []
    for step in range(n_steps):
        sample = rollout_sample(rng, sizes, vocab)
        lens = [l for sl in sample.seqlens["packed_input_ids"] for l in sl]
        pm = sample.data["prompt_mask"]
        lp = np.zeros(sum(lens), np.float32)
        off = 0
        for n in lens:
            plen = int(pm[off:off + n].sum())
            lp[off + plen - 1: off + n - 1] = (-math.log(vocab)
                                                + 0.01 * rng.standard_normal(n - plen))
            off += n
        sample.update_(SequenceSample(
            ids=list(sample.ids), keys={"packed_logprobs"}, data={"packed_logprobs": lp},
            seqlens={"packed_logprobs": [list(sl) for sl in sample.seqlens["packed_input_ids"]]}))
        for i, t in enumerate(sample.unpack()):
            t.ids = [f"s{step}-p{i}"]
            out.append(t)
    return out


def replay_update_errors(torch, dev, shard, mfc, batches, dumped, seed, worker_name):
    """Replay the model worker's train steps in this process (its
    factories, seed and batches) and hold the dump against the replay.
    Returns, per leaf, the dump's update error and that of the params from
    before the last step (what a dump taken before the step would hold),
    each ||(x - init) - (replay - init)|| / ||replay - init||, and the
    replay's seconds."""
    import areal_tpu_torch.engine.factories  # noqa: F401  (register the model and backends)
    from areal_tpu_torch.api.model_api import (FinetuneSpec, make_backend, make_interface,
                                               make_model)
    from areal_tpu_torch.base import seeding
    from areal_tpu_torch.interfaces import ppo  # noqa: F401  (register the interface)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v for k in sorted(tree) for k2, v in leaves(tree[k], f"{prefix}/{k}").items()}
        return {prefix: tree}

    t0 = time.perf_counter()
    seeding.set_random_seed(seed, worker_name)
    model = make_model(shard.model, name=shard.id.model_name, device=str(dev))
    model = make_backend(shard.backend).initialize(
        model, FinetuneSpec(train_batch_size=len(batches[0].ids)))
    actor = make_interface(shard.interface)
    # The HF weights are bf16, so their bf16 copy is the exact init.
    init = {k: v.detach().to(torch.bfloat16, copy=True)
            for k, v in leaves(model.module.get_params()).items()}
    for i, batch in enumerate(batches):
        if i == len(batches) - 1:
            before = {k: v.detach().clone() for k, v in leaves(model.module.get_params()).items()}
        actor.train_step(model, batch, mfc.mb_spec)
    after = {k: v.detach() for k, v in leaves(model.module.get_params()).items()}
    dumped = leaves(dumped)
    if sorted(dumped) != sorted(after):
        raise AssertionError(f"workers: dump leaves {sorted(dumped)} != {sorted(after)}")
    errs = {"dump": {}, "stale": {}}
    for k, a in after.items():
        a = a.double()
        step = a - init[k].double()
        norm = float(step.norm())
        moved = float((dumped[k].to(dev).double() - init[k].double()).norm())
        if norm == 0 or moved == 0:
            raise AssertionError(f"workers: {k} did not move from init (replay {norm}, "
                                 f"dump {moved})")
        errs["dump"][k] = float((dumped[k].to(dev).double() - a).norm()) / norm
        errs["stale"][k] = float((before[k].double() - a).norm()) / norm
    del model, init, before, after, a, step
    torch.cuda.empty_cache()
    return errs, time.perf_counter() - t0


def workers_phase(torch, rng, dev, cfg, seed, card, train_step_s=None, sizes=TRAIN_SIZES,
                  server_slots=4, greedy_lens=(300, 700, 1200, 2000), greedy_new=32):
    """The trainer half of the worker system through its entry point,
    LocalController(ExperimentConfig).run(): a spawned model worker hosts
    the PPO actor (loaded from an HF directory of seeded random bf16
    weights; float32 params and Adam moments, bf16 compute, remat full)
    and pulls the trajectories this process pushes as a rollout worker
    would; the inline master runs the actor_train MFC for WORKER_STEPS
    steps with the raw-dump weight hand-off after each. Then a
    GenerationServer in this process takes the last dump through
    /update_weights_from_disk and answers greedy requests over HTTP that
    must equal an engine's built from the dumped params. The dump's
    contents are held against a replay of the same steps in this process
    (replay_update_errors)."""
    import dataclasses
    import shutil
    import tempfile

    from areal_tpu_torch import kernels
    from areal_tpu_torch.api.config import (ModelAbstraction, ModelBackendAbstraction,
                                            ModelInterfaceAbstraction, ModelShardID)
    from areal_tpu_torch.api.data_api import (MicroBatchSpec, SequenceSample,
                                              sample_from_json, sample_to_json)
    from areal_tpu_torch.api.dfg import MFCDef, ModelInterfaceType, ParamReallocHook
    from areal_tpu_torch.api.model_api import ModelName
    from areal_tpu_torch.api.system_api import (
        ExperimentConfig, ExperimentSaveEvalControl, GenerationServerConfig,
        MasterWorkerConfig, ModelShardSpec, ModelWorkerConfig)
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.engine.serving import GenRequest, ServingEngine
    from areal_tpu_torch.system.controller import LocalController
    from areal_tpu_torch.system.generation_server import GenerationServer
    from areal_tpu_torch.system.push_pull_stream import NameResolvingZmqPusher
    from areal_tpu_torch.system.weight_transfer import load_raw_params

    tmp = tempfile.mkdtemp(prefix="chip_smoke_workers_")
    # The experiment is named by the temp directory: no other run's
    # records or dumps share its keys.
    exp, trial = os.path.basename(tmp), "workers"
    nr_cfg = {"backend": "nfs", "record_root": os.path.join(tmp, "name_resolve")}
    name_resolve.reconfigure(**nr_cfg)
    fileroot = os.path.join(tmp, "fileroot")
    stats = dict(card=card)
    server = run = None
    try:
        hf_dir = os.path.join(tmp, "hf")
        stats["hf_setup_s"] = seeded_hf_dir(torch, cfg, seed, dev, hf_dir)
        # An HF directory carries its tokenizer, which the model factory
        # loads (its own generator: the phase's batches stay the same).
        tiny_tokenizer(np.random.default_rng([seed, 6]), hf_dir, 64)
        log(f"  seeded random bf16 weights ({cfg.n_layers} layers) as an HF directory in "
            f"{stats['hf_setup_s']:.1f} s")

        n_seqs = sizes["n_prompts"]
        actor = ModelName("actor", 0)
        train = MFCDef(
            name="actor_train", model_name=actor, interface_type=ModelInterfaceType.TRAIN_STEP,
            interface_impl=None, n_seqs=n_seqs,
            input_keys=("packed_input_ids", "prompt_mask", "packed_logprobs", "rewards",
                        "seq_no_eos_mask"),
            mb_spec=MicroBatchSpec(max_tokens_per_mb=sizes["max_tokens_per_mb"]),
            post_hooks=[ParamReallocHook(source=str(actor))])
        mw = ModelWorkerConfig(
            experiment_name=exp, trial_name=trial, worker_index=0,
            shards=[ModelShardSpec(
                id=ModelShardID(actor),
                model=ModelAbstraction("tpu_transformer", args=dict(model_path=hf_dir)),
                backend=ModelBackendAbstraction("jax_train", args=dict(
                    optimizer=dict(lr=5e-5, warmup_steps_proportion=0.0), remat=True,
                    row_len_multiple=sizes["row_len"], max_row_len=sizes["row_len"])),
                interface=ModelInterfaceAbstraction("ppo_actor", args=dict(
                    n_minibatches=sizes["n_minibatches"], gae_lambda=0.95)))],
            train_batch_size=n_seqs, stream_dataset=True, seed=seed, device=str(dev))
        master = MasterWorkerConfig(
            experiment_name=exp, trial_name=trial,
            exp_ctrl=ExperimentSaveEvalControl(benchmark_steps=WORKER_STEPS), rpcs=[train],
            model_topos={str(actor): [mw.worker_name]}, data_hosts=[mw.worker_name],
            n_model_workers=1, train_batch_size=n_seqs)
        ctl = LocalController(
            ExperimentConfig(experiment_name=exp, trial_name=trial, master=master,
                             model_workers=[mw]),
            name_resolve_cfg=nr_cfg, worker_env={"AREAL_FILEROOT": fileroot})
        trajs = trajectories(rng, sizes, cfg.vocab_size, WORKER_STEPS)
        wire = [sample_to_json(t) for t in trajs]
        n_tok = [sum(t.total_seqlen() for t in trajs[i * n_seqs:(i + 1) * n_seqs])
                 for i in range(WORKER_STEPS)]

        # This process plays the rollout worker: push every trajectory,
        # then wait for the trainer's acks (its WAL holds them).
        pushed = {}

        def rollout():
            try:
                pusher = NameResolvingZmqPusher(exp, trial, pusher_index=0, n_pushers=1,
                                                n_pullers=1, ack=True)
                try:
                    for i, w in enumerate(wire):
                        pusher.push(w, seq=f"0/{i}")
                    deadline = time.monotonic() + WORKERS_TIMEOUT_S
                    while pusher.unacked() and time.monotonic() < deadline:
                        pusher.drain_acks()
                        time.sleep(0.05)
                    pushed["unacked"] = pusher.unacked()
                finally:
                    pusher.close()
            except Exception as e:  # reported after the run
                pushed["error"] = repr(e)

        feeder = threading.Thread(target=rollout, daemon=True)
        feeder.start()
        t0 = time.perf_counter()
        result = ctl.run(timeout=WORKERS_TIMEOUT_S)
        stats["run_s"] = time.perf_counter() - t0
        feeder.join(timeout=60)
        if pushed.get("error") or pushed.get("unacked", 1):
            raise AssertionError(f"workers: the rollout side failed: {pushed}")
        summary = result["perf_summary"]
        steps = [s["actor_train"] for s in summary["mfc_stats"]]
        if result["global_step"] != WORKER_STEPS or len(steps) != WORKER_STEPS:
            raise AssertionError(f"workers: {result['global_step']} steps, "
                                 f"{len(steps)} reported")
        bad = [k for s in steps for k, v in s.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"workers: non-finite MFC stats {bad}")
        counts = {k: int(sum(s[f"launches/{k}"] for s in steps)) for k in kernels.launches}
        on_card = dev.type == "cuda"
        for k in ("flash_attn_fwd_bf16", "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16",
                  "packed_gae_f32"):
            if on_card and counts[k] <= 0:
                raise AssertionError(f"workers: kernel {k} was not launched in the model worker")
        version = name_resolve.get(names.model_version(exp, trial, actor.role))
        if version != str(WORKER_STEPS):
            raise AssertionError(f"workers: published model version {version}")
        e2e = [h[0] for h in summary["history"]]
        stats.update(
            step_e2e_s=e2e, mfc_sec=[s["perf/sec"] for s in steps],
            mfc_elapsed_s=[s["perf/elapsed"] for s in steps],
            dump_s=[s["param_realloc/dump_s"] for s in steps], step_tokens=n_tok,
            peak_memory_gb=max(s["perf/mem_peak_bytes_in_use"] for s in steps) / 1e9,
            ppo_stats=steps, worker_launches=counts)
        log(f"  {WORKER_STEPS} actor_train steps through LocalController in "
            f"{stats['run_s']:.1f} s (worker start, HF load, steps, exit): tokens {n_tok}; "
            f"master step e2e {[round(x, 3) for x in e2e]} s, MFC perf/sec "
            f"{[round(x, 3) for x in stats['mfc_sec']]} s"
            f"{'' if train_step_s is None else f' (direct train_step {train_step_s:.2f} s)'}; "
            f"raw dump "
            f"{[round(x, 2) for x in stats['dump_s']]} s; worker peak device memory "
            f"{stats['peak_memory_gb']:.2f} GB; loss "
            f"{[round(s['ppo_actor/loss'], 5) for s in steps]}, importance_weight "
            f"{[round(s['ppo_actor/importance_weight'], 4) for s in steps]}; {card}")
        log(f"  launches in the model worker: {counts}")

        # The dump's contents: the same steps replayed here on the batches
        # the worker's data manager gathers (the wire's JSON, oldest first).
        dump_dir = os.path.join(fileroot, "param_realloc", exp, trial, actor.role)
        dumped, dump_version = load_raw_params(dump_dir)
        if dump_version != WORKER_STEPS:
            raise AssertionError(f"workers: the dump holds version {dump_version}")
        batches = [SequenceSample.gather([
            sample_from_json(json.loads(json.dumps(w))).select_keys(train.input_keys)
            for w in wire[i * n_seqs:(i + 1) * n_seqs]]) for i in range(WORKER_STEPS)]
        errs, stats["replay_s"] = replay_update_errors(
            torch, dev, mw.shards[0], train, batches, dumped, seed, mw.worker_name)
        stats["update_err"] = max(errs["dump"].values())
        stats["stale_update_err"] = min(errs["stale"].values())
        per_leaf = ", ".join(f"{k} {errs['dump'][k]:.2e} / {errs['stale'][k]:.2e}"
                             for k in errs["dump"])
        log(f"  replay in this process ({stats['replay_s']:.1f} s): the dump's update error "
            f"per leaf at most {stats['update_err']:.3e} (limit {WORKERS_UPDATE_RTOL}); the "
            f"params from before step {WORKER_STEPS} read at least "
            f"{stats['stale_update_err']:.3e} (per leaf, dump / before: {per_leaf})")
        if not stats["update_err"] <= WORKERS_UPDATE_RTOL < stats["stale_update_err"]:
            raise AssertionError(
                f"workers: the dump's update is off the replay's by {stats['update_err']:.3e} "
                f"(a stale dump reads {stats['stale_update_err']:.3e}; limit "
                f"{WORKERS_UPDATE_RTOL})")

        # The last dump into a GenerationServer over HTTP. The server runs
        # under a trial of its own: it leaves when its trial's status reads
        # COMPLETE, which the master wrote for the training trial.
        gcfg = GenerationServerConfig(
            experiment_name=exp, trial_name="serve", server_index=0,
            model=ModelAbstraction("tpu_transformer", args=dict(config=dataclasses.asdict(cfg))),
            max_concurrent_requests=server_slots, max_seq_len=4096, kv_page_size=128,
            decode_block_steps=16, prefill_chunk=1024, seed=seed, device=str(dev))
        server = GenerationServer()
        server.configure(gcfg, experiment_name=exp, trial_name=gcfg.trial_name,
                         worker_name=gcfg.worker_name)
        run = threading.Thread(target=server.run, daemon=True)
        run.start()
        url = server.address
        reqs = [GenRequest(qid=f"greedy{i}", input_ids=rng.integers(0, cfg.vocab_size, n).tolist(),
                           max_new_tokens=greedy_new, greedy=True, stop_token_ids=(STOP_TOKEN,))
                for i, n in enumerate(greedy_lens)]
        kernels.reset_launches()
        status, _, upd = http_call(url, "/update_weights_from_disk", {
            "model_path": dump_dir, "allow_interrupt": True, "version": WORKER_STEPS})
        if status != 200 or not upd.get("success") or upd["source"] != "disk_raw":
            raise AssertionError(f"workers: weight update failed: {status} {upd}")
        over_http = {}
        for r in reqs:  # one at a time, as the engine below runs them
            status, _, reply = http_call(url, "/generate", generate_body(r))
            if status != 200 or reply["version_start"] != WORKER_STEPS:
                raise AssertionError(f"workers: /generate {r.qid}: {status} {reply}")
            over_http[r.qid] = reply["output_ids"]
        server_counts = dict(kernels.launches)
        _, _, m = http_call(url, "/metrics")
        for k in ("flash_attn_fwd_bf16", "paged_decode_bf16"):
            if on_card and server_counts[k] <= 0:
                raise AssertionError(f"workers: kernel {k} was not launched by the server")
        server.exit()
        run.join(timeout=120)
        server = None
        torch.cuda.empty_cache()

        engine = ServingEngine(
            cfg=cfg, params=cast_tree(dumped, torch.bfloat16), max_batch_size=server_slots,
            max_seq_len=4096, decode_block_steps=16, eos_token_id=None, page_size=128,
            prefill_chunk=1024, device=dev)
        del dumped
        engine.start()
        try:
            direct = {}
            for r in reqs:
                res, _ = run_requests(engine, [GenRequest(
                    qid=r.qid, input_ids=r.input_ids, max_new_tokens=r.max_new_tokens,
                    greedy=True, stop_token_ids=r.stop_token_ids)])
                direct[r.qid] = res[r.qid].output_ids
        finally:
            engine.stop()
        if over_http != direct:
            raise AssertionError("workers: greedy tokens over HTTP differ from the engine's "
                                 "on the dumped params")
        stats.update(
            load_s=upd["load_s"], last_weight_stage_s=float(m["areal:last_weight_stage_s"]),
            last_weight_swap_s=float(m["areal:last_weight_swap_s"]),
            server_launches=server_counts,
            launches={k: counts[k] + server_counts[k] for k in counts})
        log(f"  server took the step-{WORKER_STEPS} dump: load_s {upd['load_s']:.3f}, "
            f"last_weight_stage_s {stats['last_weight_stage_s']}, last_weight_swap_s "
            f"{stats['last_weight_swap_s']}; {len(reqs)} greedy requests over HTTP equal the "
            f"engine's on the dumped params ({sum(map(len, direct.values()))} tokens); "
            f"launches through the server {server_counts}; {card}")
        return stats
    finally:
        if server is not None:
            server.exit()
            run.join(timeout=120)
        shutil.rmtree(tmp, ignore_errors=True)


# The async_ppo phase at real size; a rehearsal on the CPU passes smaller
# ones. The reference's override keys, as a user would pass them.
ASYNC_SIZES = dict(n_prompts=64, prompt=(256, 1024), train_batch_size=8, group=4,
                   max_new_tokens=256, offpolicy=1, steps=2, slots=16, max_seq_len=4096,
                   row_len=4096, max_tokens_per_mb=16384, n_minibatches=4, words=400)
ASYNC_TIMEOUT_S = 900.0
# The async_ppo phase's depth (the weight_plane phase's loop and the
# agentic phase run the async loop too): cut to keep the default run
# inside its time limit, to 7 when the weight_plane phase joined and to
# 4 when the agentic phase did.
ASYNC_LAYERS = 4

# The fleet phase: the async loop with three servers over the weight plane
# (origin -> two servers -> the third from a peer, so a chunk has two peer
# holders), two rollout workers and in-place restarts, 4 steps, at
# FLEET_LAYERS (the async phases' depth, for the run's time limit).
# Breakers open after 2 failures and stay open 5 s; server 1's /generate
# fails 6 requests in a row from its first; FleetChaos SIGKILLs server 2
# once rollouts run (on an H100 a server's successor beats 34-40 s after
# its restart, and the steps after the first fanout took 25 s at 3 steps,
# so a kill after that fanout left no time to serve again: 4 steps and an
# early kill leave it), SIGSTOPs rollout worker 1 3 s later
# or, if it then holds no rollout slot, once it does (for good: the
# controller must kill it as hung), and delays the next 2 chunks the
# tree's first parent serves by 1 s (armed over /configure on the first
# url of the manager's sorted table, which plan_fanout makes the wave-2
# server's parent). Only 2: a fetch with no second peer to hedge to takes
# every chunk from that parent. Answers of 128 tokens and the int8 wire
# (a quarter of the float32 dump's bytes a fanout: 5.0-7.6 s against
# 14.5-34.8 s) keep the phase near 160 s.
FLEET_SIZES = dict(ASYNC_SIZES, steps=4, max_new_tokens=128)
FLEET_TIMEOUT_S = 480.0
FLEET_LAYERS = 4
FLEET = dict(servers=3, rollout_workers=2, restarts=2, breaker_fails=2,
             breaker_cooldown_s=5.0, fail_server=1, fail_hits=6, kill_server=2,
             hang_worker=1, hang_after_s=3.0, chunk_delay_s=1.0, health_ttl=None)
# The fleet's weight plane (async_ppo_phase's ``plane``): fanout 2 on the
# int8 wire.
FLEET_PLANE = dict(wire="int8", fanout=2)


def fleet_env(fleet):
    """The worker env of a fleet run: the breaker knobs, the chaos-control
    surface of the servers, the failing server's fault spec."""
    env = {"AREAL_RPC_BREAKER_FAILS": str(fleet["breaker_fails"]),
           "AREAL_RPC_BREAKER_COOLDOWN_S": str(fleet["breaker_cooldown_s"]),
           "AREAL_CHAOS_HTTP": "1"}
    if fleet.get("fail_server") is not None:
        env["AREAL_FAULTS"] = (f"gserver.generate@generation_server/{fleet['fail_server']}="
                               f"raise:k=1:n={fleet['fail_hits']}")
    if fleet.get("health_ttl"):
        env["AREAL_HEALTH_TTL"] = str(fleet["health_ttl"])
    return env


class FleetChaos(threading.Thread):
    """The fleet phase's side thread. Every 0.25 s it reads the health
    registry and the manager's /status, and: records each server's url
    and the breakers /status shows (opens, open peers); arms the chunk
    delay on the tree's first parent (again at each version, and when
    that url changes);
    SIGKILLs the kill target once rollouts run; SIGSTOPs the hang
    target ``hang_after_s`` later; and records the killed server's
    successor (its new pid and url) and its readmission. Signals go to
    the pids the workers' health records carry."""

    def __init__(self, exp, trial, fleet):
        super().__init__(daemon=True, name="fleet-chaos")
        self.exp, self.trial, self.fleet = exp, trial, fleet
        self._halt = threading.Event()
        self.urls = {}  # generation server member -> its first url
        self.breaker_opens = {}  # url -> the most openings /status showed
        self.open_seen = set()  # urls /status listed as open
        self.delayed = []  # (url, version) the chunk delay was armed at
        self.killed = self.stopped = self.moved = self.readmitted = None
        self.errors = []  # the last passes that failed (the next retries)

    def stop(self):
        self._halt.set()
        if self.is_alive():
            self.join(timeout=10)

    def gate_of(self, msg):
        """The gate an escalation's message belongs to, by the pids it
        names."""
        if self.killed and str(self.killed["pid"]) in msg:
            return "(b)"
        if self.stopped and str(self.stopped["pid"]) in msg:
            return "(c)"
        return "(b)/(c)"

    def run(self):
        from areal_tpu_torch.base.health import HealthRegistry

        registry = HealthRegistry(self.exp, self.trial)
        while not self._halt.wait(0.25):
            try:
                self._step(registry)
            except Exception as e:  # a pass that failed: the next one retries
                self.errors = (self.errors + [repr(e)])[-8:]

    def _configure(self, url, body):
        import urllib.request

        req = urllib.request.Request(url + "/configure", json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    def _step(self, registry):
        from areal_tpu_torch.base import name_resolve, names

        f = self.fleet
        alive = registry.snapshot()
        for m, rec in alive.items():
            if m.startswith("generation_server/") and rec.get("url"):
                self.urls.setdefault(m, rec["url"])
        mgr = name_resolve.get(names.gen_server_manager(self.exp, self.trial))
        status, _, body = http_raw(mgr + "/status", timeout=5)
        if status != 200:
            return
        st = json.loads(body)
        rpc_st = st.get("rpc") or {}
        for u, b in (rpc_st.get("breakers") or {}).items():
            self.breaker_opens[u] = max(self.breaker_opens.get(u, 0), int(b["opens"]))
        self.open_seen |= set(rpc_st.get("open") or [])
        healthy = st["healthy_servers"]
        now = time.monotonic_ns()
        if self.stopped is not None and not self.stopped.get("resumed"):
            # A run that ended first must not wait out a stopped worker.
            try:
                done = name_resolve.get(names.experiment_status(self.exp, self.trial))
            except name_resolve.NameEntryNotFoundError:
                done = None
            if done in ("COMPLETE", "ABORT"):
                try:
                    os.kill(self.stopped["pid"], signal.SIGCONT)
                except ProcessLookupError:
                    pass
                self.stopped["resumed"] = True
        # Armed again at every version (a fetch with one peer, a bootstrap
        # from a single holder, may have spent the last arm's delays), and
        # only once the server's poll loop has run: an explicit spec loaded
        # before its first injection point would shadow its AREAL_FAULTS.
        arm = (healthy[0], st["weight_version"]) if healthy else None
        if f.get("chunk_delay_s") and arm and (
                not self.delayed or self.delayed[-1] != arm):
            hits = self._configure(arm[0], {"faults_hits": ["worker.poll"]})["faults_hits"]
            if hits["worker.poll"] >= 1:
                self._configure(arm[0], {
                    "faults": f"weight_plane.serve_chunk=delay:n=2:delay={f['chunk_delay_s']}"})
                self.delayed.append(arm)
        if f.get("kill_server") is not None and self.killed is None \
                and st["rollout_stat"]["running"] >= 1:
            member = f"generation_server/{f['kill_server']}"
            rec = alive.get(member)
            if rec is not None:
                os.kill(int(rec["pid"]), signal.SIGKILL)
                self.killed = dict(member=member, pid=int(rec["pid"]), url=rec["url"],
                                   t_ns=now, version=st["weight_version"])
        if f.get("hang_worker") is not None and self.stopped is None and self.killed \
                and now - self.killed["t_ns"] >= f["hang_after_s"] * 1e9:
            member = f"rollout_worker/{f['hang_worker']}"
            rec = alive.get(member)
            # Stopped while it holds rollout slots: the manager must give
            # them back.
            if rec is not None and (st.get("worker_slots") or {}).get(member, 0) >= 1:
                os.kill(int(rec["pid"]), signal.SIGSTOP)
                self.stopped = dict(member=member, pid=int(rec["pid"]), t_ns=now)
        if self.killed and self.moved is None:
            rec = alive.get(self.killed["member"])
            if rec is not None and int(rec["pid"]) != self.killed["pid"]:
                self.moved = dict(pid=int(rec["pid"]), url=rec["url"], t_ns=now)
        if self.moved and self.readmitted is None and self.moved["url"] in healthy:
            self.readmitted = dict(t_ns=now, weight_version=st["weight_version"],
                                   server_version=st["server_versions"].get(self.moved["url"]))


def fleet_gates(spans, records, servers, result, chaos, fleet, plane):
    """The fleet phase's gates, from the run's trace, the servers' exit
    records, the controller's restart log and what FleetChaos saw: (a)
    the failing server's breaker opened and nothing was routed to it
    while open; (b) the killed server was restarted once in place, the
    manager moved it to its new url, and its successor's first request
    was served at no older a version than it was routed at (the seconds
    from the kill to it: time to serve again); (c) the stopped rollout worker
    was restarted as hung and the manager gave its slots back; (d) with
    ``plane``, the plane's chunk reads hedged and a hedge won, and every
    completed fetch took each byte once."""
    out = {}
    mgr = spans.get("gserver_manager", [])
    restarts = result.get("worker_restarts", [])
    out["worker_restarts"] = [{k: r[k] for k in ("worker", "why", "attempt")} for r in restarts]
    # Only the planted restarts: a hang false positive (a live worker
    # whose beat went stale) restarts another worker and fails here.
    planted = []
    if fleet.get("kill_server") is not None:
        planted.append((f"generation_server/{fleet['kill_server']}", "process died"))
    if fleet.get("hang_worker") is not None:
        planted.append((f"rollout_worker/{fleet['hang_worker']}", "heartbeat went stale"))
    if sorted((r["worker"], r["why"]) for r in restarts) != sorted(planted):
        raise AssertionError(f"fleet: restarts {out['worker_restarts']}, planted {planted}")

    def events(name):
        return sorted((r for r in mgr if r["name"] == name), key=lambda r: r["start_ns"])

    routes = [r for r in events("manager.schedule") if r["attrs"].get("routed")]
    if fleet.get("fail_server") is not None:
        url = chaos.urls.get(f"generation_server/{fleet['fail_server']}")
        opens = [r for r in events("manager.breaker_open") if r["attrs"]["server"] == url]
        windows = [(r["start_ns"], r["start_ns"] + r["attrs"]["cooldown_s"] * 1e9) for r in opens]
        to_it = [r["start_ns"] for r in routes if r["attrs"]["server"] == url]
        inside = [t for t in to_it if any(a < t < b for a, b in windows)]
        out["breaker"] = dict(server=url, opens=len(opens),
                              status_opens=chaos.breaker_opens.get(url, 0),
                              status_listed_open=url in chaos.open_seen,
                              routed_to_it=len(to_it), routed_while_open=len(inside))
        if not opens or out["breaker"]["status_opens"] < 1 or not out["breaker"][
                "status_listed_open"] or inside:
            raise AssertionError(f"fleet gate (a): {out['breaker']}")
    if fleet.get("kill_server") is not None:
        k = chaos.killed
        if k is None:
            raise AssertionError("fleet gate (b): the server was never killed")
        mine = [r for r in restarts if r["worker"] == k["member"]]
        moved = [r for r in events("manager.server_moved") if r["attrs"]["old"] == k["url"]]
        if len(mine) != 1 or mine[0]["why"] != "process died" or chaos.moved is None \
                or not moved or moved[0]["attrs"]["new"] != chaos.moved["url"]:
            raise AssertionError(f"fleet gate (b): restarts {mine}, moves "
                                 f"{[r['attrs'] for r in moved]}, successor {chaos.moved}")
        new = chaos.moved["url"]
        to_new = [r for r in routes if r["attrs"]["server"] == new]
        served = sorted((r for r in spans.get(k["member"], [])
                         if r["name"] == "server.generate" and r["pid"] == chaos.moved["pid"]
                         and "n_tokens" in r["attrs"] and not r["attrs"].get("error")),
                        key=lambda r: r["start_ns"])
        if not to_new or not served:
            raise AssertionError(f"fleet gate (b): the successor at {new} was routed "
                                 f"{len(to_new)} and served {len(served)} request(s)")
        first_route, first = to_new[0], served[0]
        out["restart"] = dict(
            server=k["member"], old=k["url"], new=new,
            restarted_s=(mine[0]["t_ns"] - k["t_ns"]) / 1e9,
            first_beat_s=(chaos.moved["t_ns"] - k["t_ns"]) / 1e9,
            readmitted=chaos.readmitted,
            first_routed_at_version=first_route["attrs"]["version"],
            first_served_version=first["attrs"]["version_start"],
            time_to_serve_again_s=(first["end_ns"] - k["t_ns"]) / 1e9)
        # The successor re-synced before it served: never behind the
        # version it was routed at (a fanout in flight may put it ahead).
        if first["attrs"]["version_start"] < first_route["attrs"]["version"] \
                or first_route["attrs"]["version"] < k["version"]:
            raise AssertionError(f"fleet gate (b): {out['restart']}")
    if fleet.get("hang_worker") is not None:
        s = chaos.stopped
        member = f"rollout_worker/{fleet['hang_worker']}"
        mine = [r for r in restarts if r["worker"] == member]
        reclaimed = [r["attrs"]["slots"] for r in events("manager.reclaim")
                     if r["attrs"]["worker"] == member]
        out["hang"] = dict(worker=member, restarts=[r["why"] for r in mine],
                           slots_given_back=sum(reclaimed),
                           detected_s=((mine[0]["t_ns"] - s["t_ns"]) / 1e9
                                       if s and mine else None))
        if s is None or len(mine) != 1 or mine[0]["why"] != "heartbeat went stale" \
                or sum(reclaimed) < 1:
            raise AssertionError(f"fleet gate (c): stopped {s}, {out['hang']}")
    if plane:
        per = {n: {k: int(r.get("rpc", {}).get(k, 0)) for k in ("hedges", "hedge_wins")}
               for n, r in zip(servers, records)}
        fetches = {n: [r["attrs"] for r in spans.get(n, [])
                       if r["name"] == "server.weight_fetch" and "fetch_s" in r["attrs"]]
                   for n in servers}
        ingress = {n: [a.get("ingress_payload_equivalents") for a in fs]
                   for n, fs in fetches.items()}
        races = {n: [(a.get("n_upstreams"), a.get("hedged_chunks"), a.get("hedge_wins"))
                     for a in fs] for n, fs in fetches.items()}
        out["hedging"] = dict(per_server=per, delayed_parents=list(chaos.delayed),
                              ingress_payload_equivalents=ingress,
                              fetches_upstreams_races_wins=races)
        if sum(p["hedges"] for p in per.values()) < 1 \
                or sum(p["hedge_wins"] for p in per.values()) < 1 \
                or any(x != 1.0 for v in ingress.values() for x in v) \
                or not all(ingress.values()):
            raise AssertionError(f"fleet gate (d): {out['hedging']}")
    log(f"  fleet: {json.dumps(out)}")
    return out


def tiny_tokenizer(rng, save_dir, n_words):
    """A WordPiece tokenizer over a seeded vocabulary, saved as an HF
    tokenizer in `save_dir`: `n_words` distinct words, the numbers 0-99
    and the words of the math prompts, each one token, and the single
    characters (alone and as "##" continuations) that spell anything
    else. The vocabulary is built, not trained (the trainer's ids follow
    its hash order, which changes from process to process), so a seed
    gives the same ids in every run. Returns the words."""
    import string

    from tokenizers import Tokenizer
    from tokenizers.models import WordPiece
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast

    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = sorted({"".join(rng.choice(letters, int(rng.integers(3, 8))))
                    for _ in range(n_words)})
    chars = list(string.ascii_lowercase + string.digits + string.punctuation)
    vocab = ["[UNK]", "[EOS]", *words, *map(str, range(100)),
             *"the answer is boxed what plus".split(), *chars, *("##" + c for c in chars)]
    tok = Tokenizer(WordPiece({t: i for i, t in enumerate(dict.fromkeys(vocab))},
                              unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "tokenizer.json")
    tok.save(path)
    PreTrainedTokenizerFast(tokenizer_file=path, eos_token="[EOS]", pad_token="[EOS]",
                            unk_token="[UNK]").save_pretrained(save_dir)
    return words


def math_prompt_rows(rng, n, lo_hi, words):
    """`n` math prompts of lo..hi tokens under the tiny tokenizer (one
    token a word), each asking for a sum with its numeric answer."""
    rows = []
    for i in range(n):
        a, b = (int(x) for x in rng.integers(1, 50, 2))
        ask = f"what is {a} plus {b}"
        n_fill = max(0, _draw(rng, lo_hi) - len(ask.split()))
        rows.append(dict(query_id=f"q{i}", task="math",
                         prompt=" ".join(rng.choice(words, n_fill)) + " " + ask,
                         solutions=[f"\\boxed{{{a + b}}}"]))
    return rows


def read_trace(trace_dir):
    """Every span record of the run's trace shards, by worker label."""
    out = {}
    for name in sorted(os.listdir(trace_dir)):
        worker = pid = None
        with open(os.path.join(trace_dir, name)) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("kind") == "header":
                    worker, pid = rec["worker"], rec.get("pid")
                elif rec.get("kind") == "span":
                    rec["pid"] = pid  # the process: a restarted worker has two
                    out.setdefault(worker, []).append(rec)
    return out


def async_ppo_phase(torch, rng, dev, cfg, seed, card, sizes=ASYNC_SIZES, disagg=False,
                    plane=None, agentic=False, fleet=None):
    """The async RL loop through the port's entry point,
    areal_tpu_torch.training.main_async_ppo.main(argv), with the
    reference's override keys: a GenerationServer (with ``disagg``, a
    prefill and a decode server with a KV tier, the prefix cache and the
    manager's prefix index, every rollout handed off; with ``plane``, two
    servers fed by the weight plane, ``gen_weight_plane=true`` at fanout
    degree 1 on ``plane["wire"]``), the gserver manager,
    a rollout worker running the math agent and env, and a model worker
    training the actor (loaded with the server from an HF directory of
    seeded random weights and the tiny tokenizer) on the pushed
    trajectories, handing each step's weights back through the manager's
    fanout. Tracing is on: the spans give the staleness of every trained
    sample, the fanouts and the refused allocations; the server's exit
    record gives its kernel launches and peak memory.

    With ``agentic`` (the agentic phase, ``sizes`` AGENTIC_SIZES) the
    rollout worker runs the tool-use agent and env instead (turn 0 calls
    python, turn 1 the calculator, turn 2 answers; every later turn a
    continuation of the same qid, the server's prefix cache on), python
    tool calls and the grader's sympy jobs go to a fleet of reward
    executors (``python -m areal_tpu_torch.system.reward_executor``)
    started around the run, executor 0 armed to die on its first submit,
    and samples are admitted under
    AREAL_TASK_STALENESS_WINDOWS=agentic:<window>, which also bounds every
    trained sample's lag. The trace then also gives the tool
    observations, the failed episodes and each chunk's re-prefill.

    ``plane["fanout"]`` (default 1) sets gen_weight_fanout.

    With ``fleet`` (the fleet phase: ``sizes`` FLEET_SIZES, options
    FLEET, ``plane`` FLEET_PLANE) the run keeps its fleet up through
    failures: ``fleet["servers"]`` servers (fed by the weight plane
    where ``plane`` is given), several rollout workers, ``worker_restarts``,
    breakers armed by AREAL_RPC_BREAKER_*, one server's /generate failing
    a few requests in a row, and a FleetChaos thread that kills one
    server and stops one rollout worker mid-run; fleet_gates holds the
    run to what the fleet must survive."""
    import shutil
    import tempfile
    from collections import Counter

    from areal_tpu_torch.base import tracing
    from areal_tpu_torch.system.generation_server import exit_record_path
    from areal_tpu_torch.training import main_async_ppo

    tag = "agentic" if agentic else "async_ppo"
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_")
    exp, trial = os.path.basename(tmp), ("agentic" if agentic else "async")
    trace_dir = os.path.join(tmp, "trace")
    fileroot = os.path.join(tmp, "fileroot")
    nr_root = os.path.join(tmp, "name_resolve")
    env = {"AREAL_RL_TRACE": "1", "AREAL_RL_TRACE_DIR": trace_dir, "AREAL_FILEROOT": fileroot}
    if fleet is not None:
        env.update(fleet_env(fleet))
    if agentic:
        env["AREAL_TASK_STALENESS_WINDOWS"] = f"agentic:{sizes['window']}"
    saved_env = {k: os.environ.get(k) for k in env}
    stats = dict(card=card)
    procs = []
    chaos = None
    try:
        t0 = time.perf_counter()
        hf_dir = os.path.join(tmp, "hf")
        words = tiny_tokenizer(rng, hf_dir, sizes["words"])
        seeded_hf_dir(torch, cfg, seed, dev, hf_dir)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            # What this process still holds from earlier phases: part of
            # its peak below.
            stats["launcher_held_gb"] = torch.cuda.memory_allocated(dev) / 1e9
        data = os.path.join(tmp, "math.jsonl")
        rows = math_prompt_rows(rng, sizes["n_prompts"], sizes["prompt"], words)
        with open(data, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        stats["setup_s"] = time.perf_counter() - t0
        argv = [
            f"experiment_name={exp}", f"trial_name={trial}", f"seed={seed}",
            f"name_resolve_root={nr_root}",
            f"actor.path={hf_dir}", f"tokenizer_path={hf_dir}",
            f"dataset.path={data}", f"dataset.max_length={sizes['prompt'][1]}",
            f"train_batch_size={sizes['train_batch_size']}",
            f"ppo.gconfig.max_new_tokens={sizes['max_new_tokens']}",
            f"ppo.max_head_offpolicyness={sizes['offpolicy']}",
            f"ppo.ppo_n_minibatches={sizes['n_minibatches']}",
            f"exp_ctrl.benchmark_steps={sizes['steps']}",
            "actor.optimizer.lr=5e-5", "actor.optimizer.warmup_steps_proportion=0.0",
            f"actor.row_len_multiple={sizes['row_len']}", f"actor.max_row_len={sizes['row_len']}",
            f"mb_spec_max_tokens={sizes['max_tokens_per_mb']}",
            f"n_rollout_workers={fleet['rollout_workers'] if fleet else 1}",
            f"gen_max_concurrent_requests={sizes['slots']}",
            f"gen_max_seq_len={sizes['max_seq_len']}",
            f"gen_kv_page_size={sizes.get('page', 128)}",
            f"gen_prefill_chunk={sizes['prompt'][1]}", f"device={dev.type}",
        ]
        servers = ["generation_server/0"]
        if agentic:
            argv += ["agent_type=tool-use", f"agent_num_turns={sizes['turns']}",
                     f"agent_scripted_tool_turns={sizes['tool_turns']}",
                     "ppo.gconfig.temperature=1.0",
                     f"gen_prefix_cache_tokens={sizes['slots'] * sizes['max_seq_len']}"]
        else:
            argv.append(f"group_size={sizes['group']}")
        if disagg:
            servers.append("generation_server/1")
            argv += ["gen_server_roles=prefill,decode", "gen_kv_tier_mb=64",
                     f"gen_prefix_cache_tokens={sizes['slots'] * sizes['max_seq_len']}",
                     "gen_kv_index_size=4096"]
        if plane is not None:
            servers.append("generation_server/1")
            argv += ["gen_weight_plane=true", f"gen_weight_fanout={plane.get('fanout', 1)}"]
            if plane.get("wire"):
                argv.append(f"gen_weight_wire_dtype={plane['wire']}")
        if fleet is not None:
            servers = [f"generation_server/{i}" for i in range(fleet["servers"])]
            argv += [f"worker_restarts={fleet['restarts']}", "recover_mode=disabled"]
        argv.append(f"n_generation_servers={len(servers)}")
        if agentic:
            t0 = time.perf_counter()
            procs, urls = start_executors(tmp, exp, trial, nr_root, sizes["executors"],
                                          sizes["exec_workers"])
            stats["executors_start_s"] = time.perf_counter() - t0
        log(f"  main_async_ppo {' '.join(argv)}")
        os.environ.update(env)
        # Re-read AREAL_RL_TRACE and the trace dir: the master runs here.
        tracing.flush()
        tracing._ENABLED, tracing._REC = None, None
        if fleet is not None:
            # It reads this process's name_resolve, which the controller
            # points at nr_root when the run starts.
            chaos = FleetChaos(exp, trial, fleet)
            chaos.start()
        t0 = time.perf_counter()
        try:
            result = main_async_ppo.main(
                argv, worker_env=env,
                timeout=(AGENTIC_TIMEOUT_S if agentic else
                         FLEET_TIMEOUT_S if fleet is not None else ASYNC_TIMEOUT_S))
        except RuntimeError as e:
            if chaos is None:
                raise
            # An escalation: the controller gave a failed worker up.
            chaos.stop()
            raise AssertionError(f"fleet gate {chaos.gate_of(str(e))}: the run escalated "
                                 f"instead of restarting in place ({e})") from e
        stats["run_s"] = time.perf_counter() - t0
        if chaos is not None:
            chaos.stop()
        tracing.flush()
        if agentic:
            try:
                procs[0].wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
            stats["executor0_exit"] = procs[0].poll()
            survivor = rexec_metrics(urls[1])
            stop_processes(procs)
        summary = result["perf_summary"]
        steps = [s["actor_train"] for s in summary["mfc_stats"]]
        if result["global_step"] != sizes["steps"] or len(steps) != sizes["steps"]:
            raise AssertionError(f"{tag}: {result['global_step']} steps, "
                                 f"{len(steps)} reported")
        bad = [k for s in steps for k, v in s.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{tag}: non-finite MFC stats {bad}")
        spans = read_trace(trace_dir)

        # The fanout landed each version on the server.
        landed = sorted(int(r["attrs"]["version"]) for r in spans.get("gserver_manager", [])
                        if r["name"] == "manager.weight_update"
                        and r["attrs"].get("n_success", 0) >= 1)
        want = list(range(1, sizes["steps"] + 1))
        # A disk update's span carries its source, a plane cutover its window.
        landed_span, landed_attr = (("server.weight_cutover", "cutover_s") if plane is not None
                                    else ("server.weight_update", "source"))
        for name in servers:
            served = sorted(int(r["attrs"]["version"]) for r in spans.get(name, [])
                            if r["name"] == landed_span and landed_attr in r["attrs"])
            if fleet is not None:
                if chaos.killed and name == chaos.killed["member"]:
                    continue  # its successor is held by gate (b)
                # A server fenced off mid-run catches up at readmission
                # to the current version only, and a version the trainer
                # superseded before its fanout began is skipped: each
                # version at most once, the last one everywhere.
                for got in (landed, served):
                    if not got or got[-1] != want[-1] or len(set(got)) != len(got) \
                            or not set(got) <= set(want):
                        raise AssertionError(f"{tag}: fanout landed versions {landed}, "
                                             f"{name} loaded {served}, want the last of "
                                             f"{want}")
                continue
            if landed != want or served != want:
                raise AssertionError(f"{tag}: fanout landed versions {landed}, {name} "
                                     f"loaded {served}, want {want}")
        sync_s = [(r["end_ns"] - r["start_ns"]) / 1e9 for r in spans["gserver_manager"]
                  if r["name"] == "manager.weight_update"]

        # Every trained sample within the staleness bound: the head
        # offpolicyness, and the agentic window where there is one.
        waits = [r["attrs"] for r in spans.get("master", [])
                 if r["name"] == "buffer.wait" and r["attrs"].get("rpc") == "actor_train"]
        if fleet is None:
            waits = {a["sample_id"]: a for a in waits}
        else:
            # A restarted rollout worker starts its dataset over, so its
            # samples may repeat ids: every trained sample counts.
            waits = dict(enumerate(waits))
        n_want = sizes["steps"] * sizes["train_batch_size"]
        if len(waits) != n_want:
            raise AssertionError(f"{tag}: {len(waits)} trained samples traced, "
                                 f"want {n_want}")
        lag = Counter(a["train_step"] - a["version_start"] for a in waits.values())
        lag_bound = min(sizes["offpolicy"], sizes.get("window", sizes["offpolicy"]))
        if max(lag) > lag_bound or min(a["version_start"] for a in waits.values()) < 0:
            raise AssertionError(f"{tag}: staleness {dict(lag)} past {lag_bound} "
                                 f"(max_head_offpolicyness={sizes['offpolicy']}"
                                 + (f", agentic window {sizes['window']})" if agentic else ")"))
        staled = sum(1 for r in spans.get("gserver_manager", [])
                     if r["name"] == "manager.allocate" and r["attrs"].get("reason") == "staled")

        # Launches: the servers' from their exit records, the trainer's
        # from the MFC replies.
        records = []
        for name in servers:
            with open(exit_record_path(exp, trial, name)) as f:
                records.append(json.load(f))
        srv = records[0]
        if plane is not None or fleet is not None:
            srv = dict(records[0], launches={
                k: sum(r["launches"][k] for r in records) for k in records[0]["launches"]},
                peak_memory_bytes=max(r["peak_memory_bytes"] for r in records),
                metrics={k: sum(r["metrics"].get(k, 0.0) for r in records)
                         for k in ("total_generated", "last_weight_stage_s",
                                   "last_weight_swap_s")})
        if fleet is not None:
            stats["fleet"] = fleet_gates(spans, records, servers, result, chaos, fleet,
                                         plane is not None)
        if plane is not None:
            fetches = {name: [r["attrs"] for r in spans.get(name, [])
                              if r["name"] == "server.weight_fetch" and "fetch_s" in r["attrs"]]
                       for name in servers}
            stats["plane"] = dict(
                wire=plane.get("wire") or "raw",
                fetch_s={n: [a["fetch_s"] for a in f] for n, f in fetches.items()},
                verify_s={n: [a["verify_s"] for a in f] for n, f in fetches.items()},
                bytes_from_origin={n: [a["bytes_from_origin"] for a in f]
                                   for n, f in fetches.items()},
                bytes_from_peers={n: [a["bytes_from_peers"] for a in f]
                                  for n, f in fetches.items()},
                cutover_s={n: [r["attrs"]["cutover_s"] for r in spans.get(n, [])
                               if r["name"] == "server.weight_cutover"
                               and "cutover_s" in r["attrs"]] for n in servers},
                max_rss_gb={n: r["max_rss_bytes"] / 1e9 for n, r in zip(servers, records)})
            # Degree 1 over two servers is the chain origin -> S0 -> S1:
            # every version's second hop is peer to peer. (A fleet run's
            # fenced and restarted servers skip versions: gate (d) holds
            # its fetches.)
            if fleet is None and (
                    any(f != sizes["steps"] for f in map(len, fetches.values()))
                    or min(sum(f[i] for f in stats["plane"]["bytes_from_peers"].values())
                           for i in range(sizes["steps"])) <= 0):
                raise AssertionError(f"async_ppo: plane fetches {stats['plane']}")
            log(f"  weight plane: fetch s {stats['plane']['fetch_s']}, verify s "
                f"{stats['plane']['verify_s']}, cutover s {stats['plane']['cutover_s']}, "
                f"bytes from the origin {stats['plane']['bytes_from_origin']}, from peers "
                f"{stats['plane']['bytes_from_peers']}; host RSS GB "
                f"{stats['plane']['max_rss_gb']}")
        if disagg:
            srv = dict(records[0], launches={
                k: sum(r["launches"][k] for r in records) for k in records[0]["launches"]},
                peak_memory_bytes=max(r["peak_memory_bytes"] for r in records),
                metrics={k: sum(r["metrics"].get(k, 0.0) for r in records)
                         for k in ("total_generated", "kv_export_total", "kv_import_total",
                                   "last_weight_stage_s", "last_weight_swap_s")})
            # Handoffs still in flight when the run ends are neither ok
            # nor failed yet, so the decode side may count more imports.
            handoff = dict(records[0]["handoff"],
                           imports=records[1]["metrics"]["kv_import_total"])
            if handoff["ok"] <= 0 or handoff["imports"] < handoff["ok"]:
                raise AssertionError(f"async_ppo: handoffs {handoff}")
            stats["handoff"] = handoff
        worker_counts = {k: int(sum(s.get(f"launches/{k}", 0) for s in steps))
                         for k in srv["launches"]}
        if dev.type == "cuda":
            for k in ("flash_attn_fwd_bf16", "paged_decode_bf16"):
                if srv["launches"][k] <= 0:
                    raise AssertionError(f"{tag}: kernel {k} was not launched by the server")
            for k in ("flash_attn_fwd_bf16", "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16",
                      "packed_gae_f32"):
                if worker_counts[k] <= 0:
                    raise AssertionError(
                        f"{tag}: kernel {k} was not launched in the model worker")
        if any(r["version"] != sizes["steps"] for r in records):
            raise AssertionError(f"{tag}: the servers ended at versions "
                                 f"{[r['version'] for r in records]}")
        gen_tokens = srv["metrics"]["total_generated"]
        stats.update(
            global_step=result["global_step"], server_final_version=srv["version"],
            step_e2e_s=[h[0] for h in summary["history"]],
            mfc_sec=[s["perf/sec"] for s in steps],
            dump_s=[s["param_realloc/dump_s"] for s in steps],
            output_tokens=gen_tokens, output_tok_per_s=gen_tokens / stats["run_s"],
            last_weight_sync_s=sync_s, server_stage_s=srv["metrics"]["last_weight_stage_s"],
            server_swap_s=srv["metrics"]["last_weight_swap_s"], staled_allocations=staled,
            staleness_hist={int(k): v for k, v in sorted(lag.items())},
            importance_weight_step1=steps[0]["ppo_actor/importance_weight"],
            peak_memory_gb={
                "model_worker": max(s["perf/mem_peak_bytes_in_use"] for s in steps) / 1e9,
                "generation_server": srv["peak_memory_bytes"] / 1e9,
                "launcher": (torch.cuda.max_memory_allocated(dev) / 1e9
                             if dev.type == "cuda" else 0.0)},
            server_launches=srv["launches"], worker_launches=worker_counts,
            launches={k: worker_counts[k] + srv["launches"][k] for k in worker_counts})
        log(f"  {stats['global_step']} async PPO steps in {stats['run_s']:.1f} s (worker start, "
            f"HF loads, rollouts, steps, exit); master step e2e "
            f"{[round(x, 3) for x in stats['step_e2e_s']]} s, MFC perf/sec "
            f"{[round(x, 3) for x in stats['mfc_sec']]} s, raw dump "
            f"{[round(x, 2) for x in stats['dump_s']]} s; {card}")
        log(f"  rollout output {gen_tokens:.0f} tokens, {stats['output_tok_per_s']:.1f} tokens/s "
            f"over the run; manager fanouts (last_weight_sync_s) "
            f"{[round(x, 3) for x in sync_s]} s, server stage {stats['server_stage_s']:.3f} s, "
            f"swap {stats['server_swap_s']:.3f} s; allocations refused as staled {staled}; "
            f"staleness (train step - version_start: samples) {stats['staleness_hist']}; "
            f"importance_weight of step 1 {stats['importance_weight_step1']:.6f}")
        log(f"  peak device memory (GB) {stats['peak_memory_gb']} (the launcher held "
            f"{stats.get('launcher_held_gb', 0.0):.2f} GB from earlier phases at the start); "
            f"launches in the model worker "
            f"{worker_counts}, in the server {srv['launches']}")
        if agentic:
            agentic_gates(stats, sizes, steps, spans.get("rollout_worker/0", []), srv, survivor)
        return stats
    finally:
        if chaos is not None:
            chaos.stop()
        stop_processes(procs)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tracing._ENABLED, tracing._REC = None, None
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 12: sync PPO end to end
# ----------------------------------------------------------------------

SYNC_SIZES = dict(n_prompts=64, prompt=(256, 1024), train_batch_size=8, group=4,
                  max_new_tokens=256, steps=2, row_len=4096, max_tokens_per_mb=16384,
                  n_minibatches=4, words=400, greedy_prompts=16, greedy_new=64,
                  offload_seqs=4, offload_len=1024)
SYNC_TIMEOUT_S = 900.0
# The sync_ppo phase's depth: its four engines (actor, ref, two critics)
# share the card, and the run's time limit (7 when it joined, 4 since
# the agentic phase did).
SYNC_LAYERS = 4
# Step 1's first actor minibatch runs on the weights that generated the
# batch, so the generator's (paged decode) and the training forward's
# (flash) logprobs of its tokens differ only by bf16 rounding. Their mean
# |difference| is the gate on the generator. The importance weight is
# kept, but cannot show a wrong generator: over tokens sampled from the
# generator's distribution its expectation is 1 whatever that
# distribution is. On an H100 the sound path read 0.0072, and two planted
# faults in the generator's decode read 0.116 (lengths one short) and
# 0.253 (page table rolled by a row) with importance weights 0.996 and
# 0.986.
SYNC_LP_TOL = 0.03
SYNC_IW_TOL = 0.02
SYNC_KERNELS = ("flash_attn_fwd_bf16", "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16",
                "packed_gae_f32", "paged_decode_bf16")


def offload_check(torch, rng, dev, cfg, params, sizes):
    """Offload on a train engine of the phase's depth (float32 params and
    AdamW moments): the device bytes it frees, its seconds, the lazy
    restore's seconds, and a forward after the restore bit-equal to one
    before. ``params`` is a one-element list the engine takes the tree out
    of, so no other reference keeps its storage on the card."""
    from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.engine.optimizer import OptimizerConfig
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine

    eng = TorchTrainEngine(cfg, params.pop(), optimizer_config=OptimizerConfig(lr=1e-5),
                           row_len_multiple=sizes["offload_len"], device=dev)
    n, T = sizes["offload_seqs"], sizes["offload_len"]
    sample = SequenceSample.from_default(
        ids=[f"o{i}" for i in range(n)], seqlens=[T] * n,
        data={"packed_input_ids": rng.integers(0, cfg.vocab_size, n * T).astype(np.int32)})
    before = eng.forward(sample, MicroBatchSpec()).data["logprobs"]
    sync(torch, dev)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    t0 = time.perf_counter()
    eng.offload()
    sync(torch, dev)
    offload_s = time.perf_counter() - t0
    freed = held - (torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0)
    t0 = time.perf_counter()
    eng._ensure_loaded()  # what the next engine call runs first
    sync(torch, dev)
    restore_s = time.perf_counter() - t0
    after = eng.forward(sample, MicroBatchSpec()).data["logprobs"]
    if not np.array_equal(before, after):
        raise AssertionError(f"sync_ppo: the forward after the restore differs by "
                             f"{float(np.abs(before - after).max())}")
    del eng
    return dict(freed_gb=freed / 1e9, offload_s=offload_s, restore_s=restore_s,
                forward_bit_equal=True)


def greedy_agreement(torch, dev, cfg, params, prompts, new_tokens, eos):
    """Greedy tokens of the batch generator (models/generation.py) and of a
    ServingEngine on the same params: the number of prompts whose outputs
    are equal."""
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.engine.serving import GenRequest, ServingEngine
    from areal_tpu_torch.models.generation import generate_tokens

    gen = generate_tokens(params, cfg, prompts,
                          GenerationHyperparameters(greedy=True, max_new_tokens=new_tokens),
                          torch.Generator(device=dev).manual_seed(0), eos_token_id=eos)
    engine = ServingEngine(cfg=cfg, params=params, max_batch_size=len(prompts),
                           max_seq_len=max(map(len, prompts)) + new_tokens + 128,
                           decode_block_steps=16, eos_token_id=eos, page_size=128,
                           prefill_max_batch=len(prompts), device=dev)
    engine.start()
    try:
        res, _ = run_requests(engine, [GenRequest(qid=f"g{i}", input_ids=list(p),
                                                  max_new_tokens=new_tokens, greedy=True)
                                       for i, p in enumerate(prompts)])
    finally:
        engine.stop()
    return sum(res[f"g{i}"].output_ids == g["output_ids"] for i, g in enumerate(gen))


def sync_ppo_phase(torch, rng, dev, cfg, seed, card, sizes=SYNC_SIZES):
    """Sync PPO through the port's entry point,
    areal_tpu_torch.training.main_sync_ppo.main(argv), with the reference's
    override keys: a spawned model worker builds ``ppo-math`` with the
    actor, the reference and the critic (critic@0 for critic_inf, critic@1
    trained) on one HF directory of seeded random weights and the reward on
    the mock backend, generates in the actor's engine on the card (flash
    prefill, paged_decode_bf16 decode steps, sampled at temperature 1),
    grades the answers, computes the reference logprobs and the critic's
    values, and trains the actor and the critic with GAE. Then, in this
    process: greedy tokens of the batch generator against a ServingEngine
    on the same params (reported), and offload on a train engine of the
    phase's depth (freed bytes, seconds, a bit-equal forward after the
    restore)."""
    import shutil
    import tempfile

    from areal_tpu_torch.models.hf import load_hf_model
    from areal_tpu_torch.system.worker_base import exit_record_path
    from areal_tpu_torch.training import main_sync_ppo

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sync_")
    exp, trial = os.path.basename(tmp), "sync"
    fileroot = os.path.join(tmp, "fileroot")
    env = {"AREAL_FILEROOT": fileroot}
    saved_env = {k: os.environ.get(k) for k in env}
    stats = dict(card=card)
    try:
        t0 = time.perf_counter()
        hf_dir = os.path.join(tmp, "hf")
        words = tiny_tokenizer(rng, hf_dir, sizes["words"])
        seeded_hf_dir(torch, cfg, seed, dev, hf_dir)
        data = os.path.join(tmp, "math.jsonl")
        rows = math_prompt_rows(rng, sizes["n_prompts"], sizes["prompt"], words)
        with open(data, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        stats["setup_s"] = time.perf_counter() - t0
        argv = [
            f"experiment_name={exp}", f"trial_name={trial}", f"seed={seed}",
            f"name_resolve_root={os.path.join(tmp, 'name_resolve')}",
            f"actor.path={hf_dir}", f"critic.path={hf_dir}", "ppo.disable_value=false",
            f"tokenizer_path={hf_dir}",
            f"dataset.path={data}", f"dataset.max_length={sizes['prompt'][1]}",
            f"train_batch_size={sizes['train_batch_size']}", f"group_size={sizes['group']}",
            f"ppo.gconfig.max_new_tokens={sizes['max_new_tokens']}",
            "ppo.gconfig.temperature=1.0",
            f"ppo.ppo_n_minibatches={sizes['n_minibatches']}",
            f"exp_ctrl.benchmark_steps={sizes['steps']}",
            f"mb_spec_max_tokens={sizes['max_tokens_per_mb']}", f"device={dev.type}",
        ]
        for role in ("actor", "critic"):
            argv += [f"{role}.optimizer.lr=5e-5", f"{role}.optimizer.warmup_steps_proportion=0.0",
                     f"{role}.row_len_multiple={sizes['row_len']}",
                     f"{role}.max_row_len={sizes['row_len']}"]
        log(f"  main_sync_ppo {' '.join(argv)}")
        os.environ.update(env)
        t0 = time.perf_counter()
        result = main_sync_ppo.main(argv, worker_env=env, timeout=SYNC_TIMEOUT_S)
        stats["run_s"] = time.perf_counter() - t0
        summary = result["perf_summary"]
        steps = summary["mfc_stats"]
        if result["global_step"] != sizes["steps"] or len(steps) != sizes["steps"]:
            raise AssertionError(f"sync_ppo: {result['global_step']} steps, "
                                 f"{len(steps)} reported")
        mfcs = ("actor_gen", "rew_inf", "ref_inf", "critic_inf", "critic_train", "actor_train")
        for i, s in enumerate(steps):
            if sorted(s) != sorted(mfcs):
                raise AssertionError(f"sync_ppo: step {i + 1} ran MFCs {sorted(s)}")
            bad = [k for m in ("actor_train", "critic_train") for k, v in s[m].items()
                   if not math.isfinite(v)]
            if bad:
                raise AssertionError(f"sync_ppo: non-finite stats at step {i + 1}: {bad}")
        first = steps[0]["actor_train"]
        iw = first["ppo_actor_first_mb/importance_weight"]
        lp_diff = first["ppo_actor_first_mb/abs_logprob_diff"]
        launches = {k: int(sum(s[m].get(f"launches/{k}", 0) for s in steps for m in mfcs))
                    for k in SYNC_KERNELS + ("paged_decode_int8", "gae_scan_f32")}
        if dev.type == "cuda":
            for k in SYNC_KERNELS:
                if launches[k] <= 0:
                    raise AssertionError(f"sync_ppo: kernel {k} was not launched in the "
                                         f"model worker")
        with open(exit_record_path(exp, trial, "model_worker/0")) as f:
            record = json.load(f)
        gen = [s["actor_gen"] for s in steps]
        stats.update(
            global_step=result["global_step"],
            step_e2e_s=[h[0] for h in summary["history"]],
            mfc_sec={m: [s[m]["perf/sec"] for s in steps] for m in mfcs},
            gen_tokens=[g["perf/gen_tokens"] for g in gen],
            gen_tok_per_s=[g["perf/gen_tokens"] / g["perf/sec"] for g in gen],
            importance_weight_step1_mb1=iw,
            abs_logprob_diff_step1_mb1=lp_diff,
            approx_kl_step1_mb1=first["ppo_actor_first_mb/approx_kl"],
            importance_weight_steps=[s["actor_train"]["ppo_actor/importance_weight"]
                                     for s in steps],
            reward_mean=[s["actor_train"]["ppo_actor/reward_mean"] for s in steps],
            critic_loss=[s["critic_train"]["ppo_critic/loss"] for s in steps],
            shard_init_s=record["shard_init_s"],
            peak_memory_gb=record["peak_memory_bytes"] / 1e9,
            launches=launches)
        log(f"  {stats['global_step']} sync PPO steps in {stats['run_s']:.1f} s (worker start, "
            f"five shards built, steps, exit); master step e2e "
            f"{[round(x, 3) for x in stats['step_e2e_s']]} s; {card}")
        log(f"  MFC perf/sec by step: " + ", ".join(
            f"{m} {[round(x, 3) for x in v]}" for m, v in stats["mfc_sec"].items()))
        log(f"  actor_gen: {stats['gen_tokens']} generated tokens, "
            f"{[round(x, 1) for x in stats['gen_tok_per_s']]} tokens/s; step 1's first "
            f"minibatch, the generator's logprobs against the training forward's: mean "
            f"|difference| {lp_diff:.6f} (limit {SYNC_LP_TOL}), KL estimate "
            f"{stats['approx_kl_step1_mb1']:.6f}, importance weight {iw:.6f} (limit 1 +- "
            f"{SYNC_IW_TOL}); importance weight of each step "
            f"{[round(x, 6) for x in stats['importance_weight_steps']]}; reward mean "
            f"{stats['reward_mean']}; critic loss {stats['critic_loss']}")
        log(f"  shard build s (model, backend, interface; the reward shard loads the actor's "
            f"HF weights and drops them) {record['shard_init_s']}; the worker's peak device "
            f"memory {stats['peak_memory_gb']:.2f} GB; launches in the model worker {launches}")
        if not lp_diff <= SYNC_LP_TOL:
            raise AssertionError(
                f"sync_ppo: step 1's first minibatch: the generator's logprobs differ from the "
                f"training forward's on the same weights by {lp_diff:.6f} a token on average, "
                f"past {SYNC_LP_TOL}")
        if abs(iw - 1.0) > SYNC_IW_TOL:
            raise AssertionError(f"sync_ppo: step 1's first minibatch reads importance weight "
                                 f"{iw:.6f}, past 1 +- {SYNC_IW_TOL}")

        # In this process, on the initial weights.
        from areal_tpu_torch.api.data_api import load_hf_tokenizer

        cfg_hf, params = load_hf_model(hf_dir)
        params = cast_tree(params, torch.float32, dev)
        eos = load_hf_tokenizer(hf_dir).eos_token_id
        prompts = [rng.integers(0, cfg.vocab_size, _draw(rng, sizes["prompt"])).tolist()
                   for _ in range(sizes["greedy_prompts"])]
        stats["greedy_agree"] = greedy_agreement(torch, dev, cfg_hf,
                                                 cast_tree(params, torch.bfloat16), prompts,
                                                 sizes["greedy_new"], eos)
        log(f"  greedy tokens, the batch generator against a ServingEngine on the same bf16 "
            f"params: {stats['greedy_agree']} of {len(prompts)} prompts agree over "
            f"{sizes['greedy_new']} tokens (reported, not gated)")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        held = [params]
        del params
        stats["offload"] = offload_check(torch, rng, dev, cfg_hf, held, sizes)
        log(f"  offload of a {cfg.n_layers}-layer train engine (float32 params and AdamW "
            f"moments): {stats['offload']['freed_gb']:.3f} GB freed in "
            f"{stats['offload']['offload_s']:.3f} s, lazy restore "
            f"{stats['offload']['restore_s']:.3f} s, the forward after it bit-equal; {card}")
        return stats
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 13: disaggregated serving and the KV plane
# ----------------------------------------------------------------------

# P prefill (bf16 pool), D decode (bf16 pool, a tier and a prefix budget
# below a wave's parks, so they spill), D8 decode (int8 pool), U unified
# (bf16, the drain target and the unified reference) in the manager's
# fleet; U8 unified int8 outside it (the int8 reference).
DISAGG_SIZES = dict(wave=16, prompt=(1025, 3072), new=128, cont=6, fresh=64, cont_new=32,
                    slots=16, max_seq_len=4096, page=128, chunk=1024, d_prefix=16384,
                    tier_mb=4096, bytes_prompt=1024, burst=32, burst_prompt=3000,
                    burst_new=32, rerole_high=16384)
DISAGG_TIMEOUT_S = 300.0
# Cut in depth for the run's time limit: 14 since PR 10, 7 since the sft
# phase joined the default run, 4 since the agentic phase did (the gates
# count tokens and pages, not layers).
DISAGG_LAYERS = 4


def http_raw(url, headers=None, timeout=120.0):
    """(status, headers, raw body) of one GET."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, None, headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def kv_wire_tokens(meta, payload, n):
    """The first n tokens of every array of an int8-wire blob, as bytes."""
    import torch

    from areal_tpu_torch.engine import kv_handoff as kvh

    arrs = kvh.unpack_arrays(meta, payload)
    return {k: v[:, :, :n].contiguous().view(torch.uint8).numpy().tobytes()
            for k, v in arrs.items()}


def teacher_forced_agreement(torch, cfg, params, dev, prompts, outputs):
    """(greedy tokens within 0.1 nats of the forward's argmax, tokens,
    median |logprob - forward's|): the check of check_results, on a
    server's outputs."""
    from areal_tpu_torch.models.transformer import forward

    agree, n_tok, diffs = 0, 0, []
    for prompt, (ids, lps) in zip(prompts, outputs):
        seq = list(prompt) + ids[:-1]
        t = torch.tensor([seq], dtype=torch.int32, device=dev)
        pos = torch.arange(len(seq), dtype=torch.int32, device=dev)[None]
        with torch.inference_mode():
            logits = forward(params, cfg, t, torch.ones_like(t), pos,
                             device=dev)[0, len(prompt) - 1:]
        logp = torch.log_softmax(logits.float(), dim=-1)
        out = torch.tensor(ids, device=dev)
        picked = logp.gather(-1, out[:, None])[:, 0]
        gap = (logp.max(dim=-1).values - picked).cpu().numpy()
        agree += int((gap <= 0.1).sum())
        n_tok += len(ids)
        diffs.extend(np.abs(picked.cpu().numpy() - np.asarray(lps)).tolist())
    return agree, n_tok, float(np.median(diffs))


def disagg_phase(torch, rng, dev, cfg, seed, card, sizes=DISAGG_SIZES):
    """Disaggregated serving through the port's workers: four generation
    servers and the gserver manager spawned by LocalController (each a
    process of its own, like a launched fleet), driven by the
    PartialRolloutManager client and plain HTTP:

    1. a wave through the manager paired P -> D, the same wave on U (at
       once, and as the handoff computes it: the first token, then the
       continuation), the wave paired P -> D8, and on U8 (int8 reference):
       P -> D equals U's two-leg tokens exactly, P -> D8 passes the
       teacher-forced check, every handoff succeeds; one 1024-token
       prompt alone: the int8 pages D8 wrote from P's bf16 wire equal
       byte for byte the pages U8 wrote for it;
    2. continuations of the wave hit D's prefixes by affinity (parked or
       restored from D's tier, where its small prefix budget spilled
       them), with U's tokens;
    3. the manager drains D: every parked and tiered prefix migrates,
       D deregisters and exits with code 0, a continuation of a migrated
       session is routed to U by the prefix index and restored there;
    4. a prompt burst on P makes the manager's sizer flip U to prefill,
       and fresh work then pairs by the new roles.

    Steering: the manager routes a fresh request to the least-loaded
    pair; a shed window (the routing hint a 429 leaves, reported with
    /schedule_request) keeps D8 and U out of the first wave and D out of
    the second. The servers trace (AREAL_RL_TRACE): export, transfer,
    import, spill and restore times come from their spans; launches and
    peak memory from their exit records."""
    import asyncio
    import shutil
    import tempfile

    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.api.system_api import (
        ExperimentConfig, GenerationServerConfig, GserverManagerConfig)
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.controller import LocalController
    from areal_tpu_torch.system.generation_server import exit_record_path
    from areal_tpu_torch.system.partial_rollout import PartialRolloutManager

    tmp = tempfile.mkdtemp(prefix="chip_smoke_disagg_")
    exp, trial, ref_trial = os.path.basename(tmp), "disagg", "u8"
    trace_dir = os.path.join(tmp, "trace")
    env = {"AREAL_RL_TRACE": "1", "AREAL_RL_TRACE_DIR": trace_dir,
           "AREAL_FILEROOT": os.path.join(tmp, "fileroot")}
    saved_env = {k: os.environ.get(k) for k in env}
    nr_cfg = {"backend": "nfs", "record_root": os.path.join(tmp, "name_resolve")}
    name_resolve.reconfigure(**nr_cfg)
    os.environ["AREAL_FILEROOT"] = env["AREAL_FILEROOT"]
    model = ModelAbstraction("tpu_transformer", args=dict(config=dataclasses.asdict(cfg)))
    tier = sizes["tier_mb"] << 20
    base = dict(experiment_name=exp, trial_name=trial, model=model,
                max_concurrent_requests=sizes["slots"], max_seq_len=sizes["max_seq_len"],
                kv_page_size=sizes["page"], decode_block_steps=16,
                prefill_chunk=sizes["chunk"], prefix_cache_tokens=4 * sizes["slots"]
                * sizes["max_seq_len"], warm_on_start=True, seed=seed, device=dev.type)
    roles = {
        "P": dict(server_index=0, role="prefill"),
        "D": dict(server_index=1, role="decode", kv_tier_bytes=tier,
                  prefix_cache_tokens=sizes["d_prefix"]),
        "D8": dict(server_index=2, role="decode", kv_cache_dtype="int8",
                   kv_tier_bytes=256 << 20),
        "U": dict(server_index=3, kv_tier_bytes=tier),
        "U8": dict(server_index=5, trial_name=ref_trial, kv_cache_dtype="int8",
                   kv_tier_bytes=256 << 20),
    }
    configs = {k: GenerationServerConfig(**{**base, **v}) for k, v in roles.items()}
    mgr = GserverManagerConfig(
        experiment_name=exp, trial_name=trial, n_servers=4, train_batch_size=8,
        max_head_offpolicyness=8, kv_index_size=4096, elastic_pools=True,
        rerole_cooldown_s=2.0, prefill_queue_high_tokens=sizes["rerole_high"],
        prefill_queue_low_tokens=0, drain_timeout_s=DISAGG_TIMEOUT_S)
    ctl = LocalController(ExperimentConfig(
        experiment_name=exp, trial_name=trial, gserver_manager=mgr,
        generation_servers=list(configs.values())), name_resolve_cfg=nr_cfg, worker_env=env)
    stats = dict(card=card)
    procs = {}
    try:
        t0 = time.perf_counter()
        ctl.start_workers()
        procs = dict(zip(list(configs) + ["M"], ctl._procs))
        url = {}
        deadline = time.monotonic() + DISAGG_TIMEOUT_S
        while len(url) < len(configs) + 1:
            for k, c in configs.items():
                try:
                    url[k] = name_resolve.get(names.gen_server_url(
                        exp, c.trial_name, str(c.server_index)))
                except name_resolve.NameEntryNotFoundError:
                    pass
            try:
                url["M"] = name_resolve.get(names.gen_server_manager(exp, trial))
            except name_resolve.NameEntryNotFoundError:
                pass
            dead = [k for k, p in procs.items() if not p.is_alive()]
            if dead or time.monotonic() > deadline:
                raise AssertionError(f"disagg: fleet not up: dead {dead}, up {sorted(url)}")
            time.sleep(0.2)
        want_roles = {url[k]: configs[k].role for k in ("P", "D", "D8", "U")}
        while http_call(url["M"], "/status")[2]["pools"]["roles"] != want_roles:
            if time.monotonic() > deadline:
                raise AssertionError("disagg: the manager never learned the roles")
            time.sleep(0.2)
        stats["fleet_up_s"] = time.perf_counter() - t0
        log(f"  fleet up in {stats['fleet_up_s']:.1f} s: " + ", ".join(
            f"{k} {url[k]}" for k in url))

        def metrics(k):
            out = {}
            for n, v in http_call(url[k], "/metrics")[2].items():
                try:
                    out[n] = float(v)
                except ValueError:
                    out[n] = v
            return out

        def steer(shed, clear=()):
            """Shed windows on the manager: `shed` out of routing for an
            hour, `clear` back in (a 1 ms window)."""
            for k, ra in [(k, 3600.0) for k in shed] + [(k, 0.001) for k in clear]:
                http_call(url["M"], "/schedule_request", {
                    "qid": "", "shed_server_url": url[k], "shed_retry_after": ra})

        def through_manager(items, continuation=False):
            """generate_group (n=1) for each (qid, prompt, new) at once;
            {qid: (output ids, logprobs)}."""
            async def go():
                prm = PartialRolloutManager(url["M"], request_timeout=DISAGG_TIMEOUT_S)
                try:
                    outs = await asyncio.gather(*[prm.generate_group(
                        q, list(p), GenerationHyperparameters(n=1, max_new_tokens=n,
                                                              greedy=True),
                        continuation=continuation) for q, p, n in items])
                finally:
                    await prm.close()
                # logprobs cover the whole sequence (the prompt's are 0).
                return {q: (o.seqs[0][len(p):], list(o.logprobs[0][len(p):]))
                        for (q, p, _), o in zip(items, outs)}
            return asyncio.run(go())

        def direct(k, bodies):
            """POST /generate to one server from a thread a body;
            {qid: response}."""
            out, errors = {}, []

            def one(b):
                try:
                    st, _, reply = http_call(url[k], "/generate", b, timeout=DISAGG_TIMEOUT_S)
                    if st != 200:
                        raise RuntimeError(f"{st} {reply}")
                    out[b["qid"]] = reply
                except Exception as e:  # reported below with the qid
                    errors.append(f"{b['qid']}: {e!r}")

            threads = [threading.Thread(target=one, args=(b,)) for b in bodies]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise AssertionError(f"disagg: /generate on {k} failed: {errors[:3]}")
            return out

        def body(qid, prompt, n, **extra):
            return {"qid": qid, "input_ids": list(prompt),
                    "gconfig": {"max_new_tokens": n, "greedy": True}, **extra}

        def two_leg(k, tag, prompts, n):
            """The handoff's computation on one server: the first token,
            then prompt + it as a priority-0 continuation."""
            out = {}

            def one(q, p):
                first = http_call(url[k], "/generate", body(f"{tag}{q}", p, 1))[2]
                rest = http_call(url[k], "/generate", body(
                    f"{tag}{q}", p + first["output_ids"], n - 1, priority=0),
                    timeout=DISAGG_TIMEOUT_S)[2]
                out[q] = first["output_ids"] + rest["output_ids"]

            threads = [threading.Thread(target=one, args=(q, p)) for q, p in prompts.items()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if len(out) != len(prompts):
                raise AssertionError(f"disagg: two-leg wave on {k}: {len(out)} answers")
            return out

        V, new = cfg.vocab_size, sizes["new"]
        lo, hi = sizes["prompt"]
        wave = {f"w{i}": rng.integers(0, V, size=int(rng.integers(lo, hi + 1))).tolist()
                for i in range(sizes["wave"])}
        n_prompt = sum(len(p) for p in wave.values())

        # 1a. The wave through the manager, paired P -> D.
        steer(("D8", "U"))
        m_p0 = metrics("P")
        t1 = time.perf_counter()
        split = through_manager([(q, p, new) for q, p in wave.items()])
        stats["wave_pd_s"] = time.perf_counter() - t1
        m_p1, m_d = metrics("P"), metrics("D")
        ok = m_p1["areal:kv_handoff_ok"] - m_p0["areal:kv_handoff_ok"]
        if (ok != len(wave) or m_p1["areal:kv_handoff_failed"]
                or m_p1["areal:kv_handoff_fallback"] or m_d["areal:kv_import_total"] != ok):
            raise AssertionError(f"disagg: P -> D wave: {ok} handoffs ok, failed "
                                 f"{m_p1['areal:kv_handoff_failed']}, fallback "
                                 f"{m_p1['areal:kv_handoff_fallback']}, D imports "
                                 f"{m_d['areal:kv_import_total']}")
        if any(len(ids) != new for ids, _ in split.values()):
            raise AssertionError("disagg: a P -> D answer is short")
        # 1b. The same wave on U: at once (the unified baseline) and as the
        # handoff computes it (its tokens must be equal).
        t1 = time.perf_counter()
        uni = direct("U", [body(f"p:{q}", p, new) for q, p in wave.items()])
        stats["wave_u_s"] = time.perf_counter() - t1
        m_u = metrics("U")
        legs = two_leg("U", "u:", wave, new)
        same = sum(split[q][0] == legs[q] for q in wave)
        same_once = sum(split[q][0] == uni[f"p:{q}"]["output_ids"] for q in wave)
        log(f"  P -> D wave: {len(wave)} requests ({n_prompt} prompt tokens, {new} new each) "
            f"in {stats['wave_pd_s']:.2f} s, {ok:.0f} handoffs, fallback 0; U at once "
            f"{stats['wave_u_s']:.2f} s; tokens equal to U's two-leg run {same}/{len(wave)}, "
            f"to U's one-shot run {same_once}/{len(wave)}; P TTFT p50/p99 "
            f"{m_p1['areal:ttft_p50_ms']}/{m_p1['areal:ttft_p99_ms']} ms, D ITL p50/p99 "
            f"{m_d['areal:itl_p50_ms']}/{m_d['areal:itl_p99_ms']} ms; U TTFT "
            f"{m_u['areal:ttft_p50_ms']}/{m_u['areal:ttft_p99_ms']}, ITL "
            f"{m_u['areal:itl_p50_ms']}/{m_u['areal:itl_p99_ms']} ms; {card}")
        if same != len(wave):
            raise AssertionError(f"disagg: P -> D tokens differ from U's two-leg run on "
                                 f"{len(wave) - same} of {len(wave)} requests")

        # 1c. The wave again, paired P -> D8, and on U8.
        steer(("D",), clear=("D8",))
        wave8 = {f"e{i}": p for i, p in enumerate(wave.values())}
        t1 = time.perf_counter()
        split8 = through_manager([(q, p, new) for q, p in wave8.items()])
        stats["wave_pd8_s"] = time.perf_counter() - t1
        m_p2, m_d8 = metrics("P"), metrics("D8")
        ok8 = m_p2["areal:kv_handoff_ok"] - m_p1["areal:kv_handoff_ok"]
        if (ok8 != len(wave) or m_p2["areal:kv_handoff_failed"]
                or m_p2["areal:kv_handoff_fallback"] or m_d8["areal:kv_import_total"] != ok8):
            raise AssertionError(f"disagg: P -> D8 wave: {ok8} handoffs, D8 imports "
                                 f"{m_d8['areal:kv_import_total']}")
        legs8 = two_leg("U8", "u8:", wave8, new)
        same8 = sum(split8[q][0] == legs8[q] for q in wave8)
        params = init_params(cfg, seed=seed, device=dev)
        agree, n_tok, med = teacher_forced_agreement(
            torch, cfg, params, dev, list(wave8.values()), [split8[q] for q in wave8])
        del params
        log(f"  P -> D8 wave: {stats['wave_pd8_s']:.2f} s, {ok8:.0f} handoffs; tokens equal "
            f"to U8's two-leg run {same8}/{len(wave)} (P prefilled in bf16, U8 over its int8 "
            f"pool); teacher-forced {agree}/{n_tok} greedy tokens within 0.1 nats, median "
            f"|logprob diff| {med:.4f}")
        if agree < 0.95 * n_tok or med > 0.05:
            raise AssertionError("disagg: D8's greedy outputs disagree with the forward")

        # 1d. One prompt of one chunk, alone: D8's pages from P's bf16 wire
        # against U8's own.
        nb = sizes["bytes_prompt"]
        bprompt = rng.integers(0, V, size=nb).tolist()
        r = http_call(url["P"], "/generate", body("bytes", bprompt, 2, decode_url=url["D8"]))
        r8 = http_call(url["U8"], "/generate", body("bytes", bprompt, 2))
        if r[0] != 200 or "fallback" in r[2]["disagg"] or r8[0] != 200:
            raise AssertionError(f"disagg: the page-check request failed: {r} {r8}")
        pages = {}
        for k in ("D8", "U8"):
            st, _, man = http_call(url[k], "/kv/manifest?qid=bytes")
            st2, _, payload = http_raw(url[k] + "/kv/chunk?qid=bytes")
            if st != 200 or st2 != 200 or man["meta"]["kv_wire"] != "int8":
                raise AssertionError(f"disagg: {k} /kv/manifest {st} /kv/chunk {st2}")
            pages[k] = kv_wire_tokens(man["meta"], payload, nb)
            stats[f"int8_wire_bytes_per_token_{k}"] = len(payload) / man["meta"]["n_tokens"]
        if pages["D8"] != pages["U8"]:
            raise AssertionError("disagg: D8's int8 pages from the bf16 wire differ from U8's")
        log(f"  one {nb}-token prompt: the int8 pages D8 wrote from P's bf16 wire equal U8's "
            f"byte for byte ({sum(len(v) for v in pages['D8'].values())} bytes of data and "
            f"scales)")

        # 2. Continuations by affinity to D; some of D's parks spilled.
        steer((), clear=("D",))
        _, _, idx_d = http_call(url["D"], "/kv/index")
        tiers = {e["qid"]: e["tier"] for e in idx_d["held"]}
        spilled = [q for q in wave if tiers.get(f"{q}/0") == "host"]
        parked = [q for q in wave if tiers.get(f"{q}/0") == "hbm"]
        half = sizes["cont"] // 2
        cont_q = spilled[:half] + parked[:sizes["cont"] - min(half, len(spilled))]
        cont = {q: wave[q] + split[q][0] + rng.integers(0, V, size=sizes["fresh"]).tolist()
                for q in cont_q}
        m_d0 = metrics("D")
        got = through_manager([(q, p, sizes["cont_new"]) for q, p in cont.items()],
                              continuation=True)
        m_d1 = metrics("D")
        ref_cont = direct("U", [body(f"u:{q}", p, sizes["cont_new"], priority=0)
                                for q, p in cont.items()])
        hits = m_d1["areal:prefix_cache_hits"] - m_d0["areal:prefix_cache_hits"]
        restores = m_d1["areal:kv_restore_total"] - m_d0["areal:kv_restore_total"]
        same_c = sum(got[q][0] == ref_cont[f"u:{q}"]["output_ids"] for q in cont)
        log(f"  continuations: {len(cont)} ({len(spilled)} of D's {len(wave)} prefixes had "
            f"spilled; {min(half, len(spilled))} continued from the tier); D prefix hits "
            f"+{hits:.0f}, restores +{restores:.0f}, tokens reused "
            f"+{m_d1['areal:prefix_tokens_reused'] - m_d0['areal:prefix_tokens_reused']:.0f}; "
            f"tokens equal to U's continuation {same_c}/{len(cont)}; D spills "
            f"{m_d1['areal:kv_spill_total']:.0f}, lost {m_d1['areal:kv_prefix_lost_total']:.0f}")
        if hits != len(cont) or same_c != len(cont):
            raise AssertionError(f"disagg: continuations: {hits} prefix hits on D, {same_c} "
                                 f"equal to U's, of {len(cont)}")
        if (m_d1["areal:kv_spill_total"] <= 0 or m_d1["areal:kv_restore_total"] <= 0
                or m_d1["areal:kv_prefix_lost_total"] != 0):
            raise AssertionError(f"disagg: spills {m_d1['areal:kv_spill_total']}, restores "
                                 f"{m_d1['areal:kv_restore_total']}, lost "
                                 f"{m_d1['areal:kv_prefix_lost_total']}")

        # 3. Drain D through the manager.
        steer((), clear=("U", "D"))
        held_before = http_call(url["D"], "/kv/index")[2]["held"]
        t1 = time.perf_counter()
        st, _, res = http_call(url["M"], "/drain_server", {"url": url["D"], "reason": "smoke"})
        if st != 200 or not res.get("success"):
            raise AssertionError(f"disagg: /drain_server answered {st} {res}")
        last = None
        while procs["D"].is_alive():
            try:
                last = http_call(url["D"], "/drain", timeout=10)[2]
            except OSError:
                break
            if time.perf_counter() - t1 > DISAGG_TIMEOUT_S:
                raise AssertionError(f"disagg: the drain did not finish: {last}")
            time.sleep(0.05)
        procs["D"].join(timeout=120)
        stats["drain_wall_s"] = time.perf_counter() - t1
        code = procs["D"].exitcode
        beat = json.loads(name_resolve.get(names.health(exp, trial, "generation_server/1")))
        if code != 0 or not beat.get("stopped") or beat.get("drain_lost") != 0:
            raise AssertionError(f"disagg: D exited {code}, final beat {beat}")
        if not ctl.supervise_once():  # an exit code 0 is no failure
            raise AssertionError("disagg: the controller counted the drained server")
        try:
            name_resolve.get(names.gen_server_url(exp, trial, "1"))
            raise AssertionError("disagg: D did not deregister")
        except name_resolve.NameEntryNotFoundError:
            pass
        # The final heartbeat carries the drain's result; GET /drain's last
        # answer (when it came after the enumeration) what was held.
        held = beat.get("drain_migrated", -1)
        if held < len(held_before) or (last and last.get("done") and last["held"] != held):
            raise AssertionError(f"disagg: migrated {held} ({last}; {len(held_before)} "
                                 f"advertised before the drain)")
        stats["drain_ms"] = (last or {}).get("drain_ms")
        log(f"  drain: D migrated {held} prefixes ({len(held_before)} advertised before), "
            f"lost 0, drain {stats['drain_ms']} ms, {stats['drain_wall_s']:.1f} s to exit "
            f"code {code}")
        # A migrated session that was not continued: the index sends it to
        # U, which restores it from its tier.
        u_held = {e["qid"] for e in http_call(url["U"], "/kv/index")[2]["held"]}
        on_u = [q for q in wave if f"{q}/0" in u_held]
        if not on_u:
            raise AssertionError("disagg: no migrated prefix landed on U")
        q = next((q for q in on_u if q not in cont), on_u[0])
        # What D held for q: the wave's, or the continuation's.
        turn = (wave[q] + split[q][0] if q not in cont else cont[q] + got[q][0])
        deadline = time.monotonic() + 60
        while url["D"] not in http_call(url["M"], "/status")[2]["evicted_servers"]:
            if time.monotonic() > deadline:
                raise AssertionError("disagg: the manager never dropped D")
            time.sleep(0.2)
        time.sleep(5.0)  # two metrics polls: the index reads U's tier
        after = {q: turn + rng.integers(0, V, size=sizes["fresh"]).tolist()}
        m_u0 = metrics("U")
        mig = through_manager([(q, after[q], sizes["cont_new"])], continuation=True)
        m_u1 = metrics("U")
        ref_mig = direct("U", [body(f"u:{q}", after[q], sizes["cont_new"], priority=0)])
        if (m_u1["areal:kv_restore_total"] - m_u0["areal:kv_restore_total"] != 1
                or mig[q][0] != ref_mig[f"u:{q}"]["output_ids"]):
            raise AssertionError(f"disagg: the migrated session {q} was not restored on U "
                                 f"with U's tokens")
        log(f"  migrated session {q}: routed to U by the prefix index, restored from its "
            f"tier, tokens equal U's own continuation")

        # 4. The sizer: a prompt burst on P flips U to prefill.
        burst = [body(f"b{i}", rng.integers(0, V, size=sizes["burst_prompt"]).tolist(),
                      sizes["burst_new"]) for i in range(sizes["burst"])]
        box = {}
        burster = threading.Thread(target=lambda: box.update(direct("P", burst)))
        burster.start()
        deadline = time.monotonic() + 60
        while http_call(url["M"], "/status")[2]["pools"]["roles"][url["U"]] != "prefill":
            if time.monotonic() > deadline:
                raise AssertionError("disagg: the sizer never re-roled U")
            time.sleep(0.05)
        pairs = [http_call(url["M"], "/schedule_request",
                           {"qid": f"r{i}", "prompt_len": 64, "new_token_budget": 8})[2]
                 for i in range(4)]
        burster.join()
        if any(p.get("decode_url") != url["D8"] or p["url"] not in (url["P"], url["U"])
               for p in pairs):
            raise AssertionError(f"disagg: routing ignored U's new role: {pairs}")
        status = http_call(url["M"], "/status")[2]
        log(f"  re-role: the sizer flipped U to prefill under the burst ({len(burst)} prompts "
            f"on P); fresh pairs then {[(p['url'][-5:], p['decode_url'][-5:]) for p in pairs]}"
            f"; re-roles {[(e['from'], e['to']) for e in status['pools']['reroles']]}; breaker "
            f"openings {sum(b['opens'] for b in status['rpc']['breakers'].values())}")

        # Leave: the manager, then the servers, on COMPLETE.
        for t in (trial, ref_trial):
            name_resolve.add(names.experiment_status(exp, t), "COMPLETE", replace=True)
        for k, p in procs.items():
            p.join(timeout=180)
        codes = {k: p.exitcode for k, p in procs.items()}
        if any(c != 0 for c in codes.values()):
            raise AssertionError(f"disagg: exit codes {codes}")
        records = {}
        for k, c in configs.items():
            with open(exit_record_path(exp, c.trial_name, c.worker_name)) as f:
                records[k] = json.load(f)
        launches = {n: sum(r["launches"][n] for r in records.values())
                    for n in records["P"]["launches"]}
        for k in ("flash_attn_fwd_bf16", "paged_decode_bf16", "paged_decode_int8"):
            if dev.type == "cuda" and launches[k] <= 0:
                raise AssertionError(f"disagg: kernel {k} was not launched by the fleet")

        spans = read_trace(trace_dir)

        def attr_list(worker, name, key):
            return [r["attrs"][key] for r in spans.get(worker, [])
                    if r["name"] == name and key in r["attrs"]]

        def dur_ms(worker, name, **match):
            return [(r["end_ns"] - r["start_ns"]) / 1e6 for r in spans.get(worker, [])
                    if r["name"] == name
                    and all(r["attrs"].get(a) == v for a, v in match.items())]

        def summary(xs):
            xs = sorted(xs)
            return {"n": len(xs), "median": xs[len(xs) // 2], "max": xs[-1]} if xs else None

        stats.update(
            requests=len(wave), prompt_tokens=n_prompt, new_tokens=new,
            handoffs=dict(d=ok, d8=ok8), fallback=m_p2["areal:kv_handoff_fallback"],
            equal_two_leg=dict(d=same, d8=same8), equal_one_shot_u=same_once,
            teacher_forced=dict(agree=agree, tokens=n_tok, median_lp_diff=med),
            export_ms=summary(attr_list("generation_server/0", "server.kv_export",
                                        "export_ms")),
            transfer_ms={k: summary(attr_list(w, "server.kv_import", "transfer_ms"))
                         for k, w in (("d", "generation_server/1"),
                                      ("d8", "generation_server/2"))},
            import_ms={k: summary(attr_list(w, "server.kv_import", "import_ms"))
                       for k, w in (("d", "generation_server/1"),
                                    ("d8", "generation_server/2"))},
            handoff_bytes_bf16=summary(attr_list("generation_server/1", "server.kv_import",
                                                 "bytes")),
            handoff_tokens=summary([len(p) for p in wave.values()]),
            spill_ms=summary(dur_ms("generation_server/1", "server.kv_spill")),
            spill_bytes=summary(attr_list("generation_server/1", "server.kv_spill", "bytes")),
            restore_ms=summary(dur_ms("generation_server/1", "server.kv_restore", tier="local")
                               + dur_ms("generation_server/3", "server.kv_restore",
                                        tier="local")),
            spills=m_d1["areal:kv_spill_total"], restores=m_d1["areal:kv_restore_total"],
            prefix_lost=m_d1["areal:kv_prefix_lost_total"],
            continuations=len(cont), continued_from_tier=min(half, len(spilled)),
            migrated=held, drain_exit_code=code,
            ttft_ms=dict(p=[m_p1["areal:ttft_p50_ms"], m_p1["areal:ttft_p99_ms"]],
                         u=[m_u["areal:ttft_p50_ms"], m_u["areal:ttft_p99_ms"]]),
            itl_ms=dict(d=[m_d["areal:itl_p50_ms"], m_d["areal:itl_p99_ms"]],
                        u=[m_u["areal:itl_p50_ms"], m_u["areal:itl_p99_ms"]]),
            reroles=[(e["from"], e["to"]) for e in status["pools"]["reroles"]],
            peak_memory_gb={k: r["peak_memory_bytes"] / 1e9 for k, r in records.items()},
            launches=launches, launches_by_server={k: r["launches"] for k, r in records.items()})
        log(f"  handoff: export ms {stats['export_ms']}, transfer ms {stats['transfer_ms']}, "
            f"import ms {stats['import_ms']}; bf16 wire bytes {stats['handoff_bytes_bf16']} "
            f"for prompts of {stats['handoff_tokens']} tokens; int8 wire "
            f"{stats['int8_wire_bytes_per_token_D8']:.0f} bytes a token")
        log(f"  spill ms {stats['spill_ms']} ({stats['spill_bytes']} bytes), restore ms "
            f"{stats['restore_ms']}; peak memory GB {stats['peak_memory_gb']}; launches "
            f"{launches}; {card}")
        return stats
    finally:
        for p in procs.values():
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 14: the weight-distribution plane
# ----------------------------------------------------------------------

# The serving configuration behind the plane; the in-flight wave (two
# client threads a server, 5120 greedy tokens a request), the greedy
# checks, and the plane's 8 MiB chunks. Gate (a) needs every server to cut
# over while a request is in flight: an idle engine swaps at once, and a
# swap in the block that ends a request interrupts nothing. The two
# requests of a server start together and decode in lockstep, so they end
# together. At 7 layers on an H100 a 3072-token request took 31.7-36.9
# s against a cutover ~30.4 s after the wave's start, one server
# interrupted at 2945 of its 3072 tokens, so requests grew to 7168
# tokens; at 4 layers the cutover came 20.3 s after the wave's start, at
# 2993-3137 of 7168 tokens (a whole request 46.3-48.5 s), so 5120 tokens
# (~1.6 times the cutover's point) keep it well inside the first request.
PLANE_SIZES = dict(slots=16, max_seq_len=8192, page=128, chunk=1024, wave_threads=2,
                   wave_prompt=(256, 1024), wave_new=5120, resume_new=16,
                   greedy_lens=(300, 1200), greedy_new=32, chunk_bytes=8 << 20)
PLANE_TIMEOUT_S = 600.0
# The depths of the plane's fleet, (a) and (b), and of (c), the async loop
# over the plane: cut from 28 since the sft phase joined the default run,
# to keep it inside the run's limit; both to 4 when the agentic phase did.
PLANE_FLEET_LAYERS = 4
PLANE_LOOP_LAYERS = 4
# (c) runs at max_head_offpolicyness 0: the rollouts of step 2 start only
# once v1 has landed, so v1's fanout ends before the trainer can finish.
# At 1 the trainer could finish step 2 while v1 was still in flight from
# its source, which closes with the model worker; the manager then fans
# out the newest version, v2, and v1 never lands on the servers.
PLANE_LOOP_SIZES = dict(ASYNC_SIZES, offpolicy=0)


def greedy_tokens(torch, engine_or_url, cfg, reqs, dev=None, sz=PLANE_SIZES,
                  eos_token_id=None, phase="weight_plane"):
    """One request at a time: from a server URL over HTTP, {qid: (greedy
    output ids, version_start, version_end)}; from a ServingEngine built
    here on `engine_or_url` (a param tree) with the server's
    configuration and `eos_token_id`, {qid: greedy output ids}."""
    from areal_tpu_torch.engine.serving import GenRequest, ServingEngine

    out = {}
    if isinstance(engine_or_url, str):
        for r in reqs:
            status, _, reply = http_call(engine_or_url, "/generate", generate_body(r))
            if status != 200:
                raise AssertionError(f"{phase}: /generate {r.qid}: {status} {reply}")
            out[r.qid] = (reply["output_ids"], reply["version_start"], reply["version_end"])
        return out
    engine = ServingEngine(cfg=cfg, params=engine_or_url, max_batch_size=sz["slots"],
                           max_seq_len=sz["max_seq_len"], decode_block_steps=16,
                           eos_token_id=eos_token_id, page_size=sz["page"],
                           prefill_chunk=sz["chunk"], device=dev)
    engine.start()
    try:
        for r in reqs:
            res, _ = run_requests(engine, [GenRequest(
                qid=r.qid, input_ids=r.input_ids, max_new_tokens=r.max_new_tokens,
                greedy=True, stop_token_ids=r.stop_token_ids)])
            out[r.qid] = res[r.qid].output_ids
    finally:
        engine.stop()
    return out


def weight_plane_phase(torch, rng, dev, cfg, seed, card, sizes=PLANE_SIZES):
    """The weight-distribution plane through the port's workers:

    (a) this process dumps version 1 of perturbed float32 params
        (``dump_raw_params(..., wire_dtype="int8")``: the raw bin with its
        chunk and layout sidecars, then the int8 companion) and serves the
        dump with a WeightPlaneSource registered as a trainer's; three
        GenerationServer processes stand behind a GserverManager with
        ``weight_plane=True`` at fanout degree 1 (the chain origin -> S0 ->
        S1 -> S2), each serving a greedy wave while the fanout and the
        cutover land: requests in flight come back interrupted and finish
        on version 1; each server's greedy tokens then equal an engine's
        here on the dumped params cast to bf16; the origin sends one
        payload, the servers' ``weight_bytes_from_origin`` sum to one
        payload and ``weight_bytes_from_peers`` to two;
    (b) version 2 on the int8 wire, posted to S0 (from the origin) and S1
        (from S0) with ``/distribute_weights`` and ``/cutover_weights``:
        the leaves S0 holds assemble bit-equal to ``dequantize_wire_leaf(
        quantize_wire_leaf(x))`` computed here, and both servers' greedy
        tokens equal an engine's on those params.

    Part (c), the async RL loop over the plane, is plane_loop_phase.

    The forward and paged decode kernels must launch in every server
    after its last cutover (the exit records split the counts there)."""
    import shutil
    import tempfile

    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.system_api import (
        ExperimentConfig, GenerationServerConfig, GserverManagerConfig)
    from areal_tpu_torch.base import constants, name_resolve, names
    from areal_tpu_torch.engine import weight_client as wc
    from areal_tpu_torch.engine.serving import GenRequest
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system import weight_transfer as wt
    from areal_tpu_torch.system.controller import LocalController
    from areal_tpu_torch.system.generation_server import exit_record_path
    from areal_tpu_torch.system.weight_plane import WeightPlaneSource

    tmp = tempfile.mkdtemp(prefix="chip_smoke_plane_")
    exp, trial = os.path.basename(tmp), "plane"
    env = {"AREAL_FILEROOT": os.path.join(tmp, "fileroot")}
    saved_env = {k: os.environ.get(k) for k in env}
    nr_cfg = {"backend": "nfs", "record_root": os.path.join(tmp, "name_resolve")}
    name_resolve.reconfigure(**nr_cfg)
    os.environ.update(env)
    cb = sizes["chunk_bytes"]
    stats = dict(card=card)
    procs, src = {}, None
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        base = init_params(cfg, seed=seed, device=dev, dtype=torch.float32)
        params = perturbed(torch, base, seed + 21)
        del base
        dump_dir = os.path.join(constants.get_param_realloc_path(exp, trial), "actor")

        def dump(tree, version):
            wt.dump_raw_params(tree, dump_dir, version=version, chunk_bytes=cb, wire_dtype="int8")
            d = dict(wt.LAST_DUMP_STATS)
            out = dict(raw_s=d["seconds"] - d["wire_seconds"], int8_s=d["wire_seconds"],
                       raw_bytes=d["total_bytes"], int8_bytes=d["wire_total_bytes"])
            log(f"  dump v{version}: raw bin with its sidecars {out['raw_s']:.2f} s "
                f"({out['raw_bytes'] / 1e9:.3f} GB), int8 companion {out['int8_s']:.2f} s "
                f"({out['int8_bytes'] / 1e9:.3f} GB); {card}")
            return out

        stats["dump_v1"] = dump(params, 1)
        src = WeightPlaneSource(dump_dir, chunk_bytes=cb).start().register(exp, trial, "actor")
        V = cfg.vocab_size
        reqs = [GenRequest(qid=f"g{i}", input_ids=rng.integers(0, V, n).tolist(),
                           max_new_tokens=sizes["greedy_new"], greedy=True,
                           stop_token_ids=(STOP_TOKEN,))
                for i, n in enumerate(sizes["greedy_lens"])]
        want1 = greedy_tokens(torch, cast_tree(params, torch.bfloat16), cfg, reqs, dev, sizes)
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # The fleet: three servers behind the manager, each a process.
        model = ModelAbstraction("tpu_transformer", args=dict(config=dataclasses.asdict(cfg)))
        configs = [GenerationServerConfig(
            experiment_name=exp, trial_name=trial, server_index=i, model=model,
            max_concurrent_requests=sizes["slots"], max_seq_len=sizes["max_seq_len"],
            kv_page_size=sizes["page"], decode_block_steps=16, prefill_chunk=sizes["chunk"],
            seed=seed, device=dev.type) for i in range(3)]
        mgr_cfg = GserverManagerConfig(
            experiment_name=exp, trial_name=trial, model_name="actor", n_servers=3,
            train_batch_size=8, max_head_offpolicyness=8, weight_plane=True,
            weight_fanout_degree=1, weight_chunk_bytes=cb,
            flush_request_timeout=PLANE_TIMEOUT_S)
        ctl = LocalController(ExperimentConfig(
            experiment_name=exp, trial_name=trial, gserver_manager=mgr_cfg,
            generation_servers=configs), name_resolve_cfg=nr_cfg, worker_env=env)
        t0 = time.perf_counter()
        ctl.start_workers()
        procs = dict(zip([f"S{i}" for i in range(3)] + ["M"], ctl._procs))
        url = {}
        deadline = time.monotonic() + PLANE_TIMEOUT_S
        while len(url) < 4:
            for i, c in enumerate(configs):
                try:
                    url[f"S{i}"] = name_resolve.get(names.gen_server_url(exp, trial, str(i)))
                except name_resolve.NameEntryNotFoundError:
                    pass
            try:
                url["M"] = name_resolve.get(names.gen_server_manager(exp, trial))
            except name_resolve.NameEntryNotFoundError:
                pass
            dead = [k for k, p in procs.items() if not p.is_alive()]
            if dead or time.monotonic() > deadline:
                raise AssertionError(f"weight_plane: fleet not up: dead {dead}, up {sorted(url)}")
            time.sleep(0.2)
        servers = sorted(url[f"S{i}"] for i in range(3))
        name_of = {url[f"S{i}"]: f"S{i}" for i in range(3)}
        stats["fleet_up_s"] = time.perf_counter() - t0

        # (a) The wave in flight while version 1 fans out and cuts over.
        stop = threading.Event()
        interrupted = {u: [] for u in servers}
        timing = {u: [] for u in servers}
        errors = []
        lo, hi = sizes["wave_prompt"]
        prompts = [[rng.integers(0, V, int(rng.integers(lo, hi + 1))).tolist() for _ in range(64)]
                   for _ in range(sizes["wave_threads"] * len(servers))]

        def client(u, k):
            try:
                for i, prompt in enumerate(prompts[k]):
                    if stop.is_set():
                        return
                    qid = f"w{k}-{i}"
                    t_req = time.perf_counter()
                    st, _, r = http_call(u, "/generate", {
                        "qid": qid, "input_ids": prompt, "gconfig": {
                            "max_new_tokens": sizes["wave_new"],
                            "min_new_tokens": sizes["wave_new"], "greedy": True}})
                    if st != 200:
                        raise RuntimeError(f"{st} {r}")
                    if r["interrupted"]:
                        t_int = time.perf_counter()
                        timing[u].append(dict(index=i, tokens=len(r["output_ids"]),
                                              start_s=t_req - t_wave, reply_s=t_int - t_wave,
                                              wave_s=(t_int - t_req) * sizes["wave_new"]
                                              / max(len(r["output_ids"]), 1)))
                        # The rollout client's resubmission: the remainder
                        # as a continuation, now on the new version.
                        st, _, r2 = http_call(u, "/generate", {
                            "qid": qid, "input_ids": prompt + r["output_ids"], "priority": 0,
                            "gconfig": {"max_new_tokens": sizes["resume_new"], "greedy": True}})
                        if st != 200:
                            raise RuntimeError(f"{st} {r2}")
                        interrupted[u].append((r, r2))
                        return
            except Exception as e:  # reported below
                errors.append(f"{u}: {e!r}")

        threads = [threading.Thread(target=client, args=(u, j * len(servers) + n))
                   for j in range(sizes["wave_threads"]) for n, u in enumerate(servers)]
        t_wave = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(2.0)  # the wave is running
        with open(os.path.join(dump_dir, "step.txt"), "w") as f:
            f.write("1")
        name_resolve.add(names.model_version(exp, trial, "actor"), "1", replace=True)
        t0 = time.perf_counter()
        while http_call(url["M"], "/status")[2]["weight_version"] != 1:
            if time.perf_counter() - t0 > PLANE_TIMEOUT_S or errors:
                raise AssertionError(f"weight_plane: v1 never landed ({errors[:2]})")
            time.sleep(0.1)
        stats["fanout_s"] = time.perf_counter() - t0
        stop.set()
        for t in threads:
            t.join(timeout=PLANE_TIMEOUT_S)
        if errors:
            raise AssertionError(f"weight_plane: the wave failed: {errors[:3]}")
        status = http_call(url["M"], "/status")[2]
        row = status["weight_plane"]
        for u in servers:
            got = interrupted[u]
            if not got or any(r["version_end"] != 0 or r2["version_start"] != 1
                              or r2["version_end"] != 1 or r2["interrupted"] for r, r2 in got):
                raise AssertionError(f"weight_plane: {name_of[u]}: in-flight requests "
                                     f"{[(r['version_end'], r2['version_start']) for r, r2 in got]}"
                                     f", want interrupted at v0 and finished on v1")
        total = row["total_bytes"]
        if row["tree"] != [[[servers[0], src.address]], [[servers[1], servers[0]]],
                           [[servers[2], servers[1]]]] or row["failures"]:
            raise AssertionError(f"weight_plane: fanout row {row}")
        for u in servers:
            got = greedy_tokens(torch, u, cfg, reqs)
            if {q: ids for q, (ids, _, _) in got.items()} != want1 or any(
                    (v0, v1) != (1, 1) for _, v0, v1 in got.values()):
                raise AssertionError(f"weight_plane: {name_of[u]}'s greedy tokens differ from "
                                     f"the engine's on the dumped params")
        m = {u: {k: float(v) for k, v in http_call(u, "/metrics")[2].items()
                 if k.startswith("areal:weight_") and k not in ("areal:weight_wire",
                                                                "areal:weight_shard")}
             for u in servers}
        origin_out = src.stats()["bytes_served"].get(1, 0)
        from_origin = sum(x["areal:weight_bytes_from_origin"] for x in m.values())
        from_peers = sum(x["areal:weight_bytes_from_peers"] for x in m.values())
        if not (origin_out == total == from_origin and from_peers == 2 * total):
            raise AssertionError(f"weight_plane: origin sent {origin_out}, servers took "
                                 f"{from_origin} from it and {from_peers} from peers; payload "
                                 f"{total}")
        hops = {name_of[u]: dict(transfer_ms=m[u]["areal:weight_transfer_ms"],
                                 verify_ms=m[u]["areal:weight_verify_ms"],
                                 cutover_ms=m[u]["areal:weight_cutover_ms"],
                                 from_origin=m[u]["areal:weight_bytes_from_origin"],
                                 from_peers=m[u]["areal:weight_bytes_from_peers"])
                for u in servers}
        stats["raw"] = dict(payload_bytes=total, n_chunks=row["n_chunks"], hops=hops,
                            origin_bytes=origin_out, from_origin=from_origin,
                            from_peers=from_peers, sync_s=row["sync_s"],
                            interrupted={name_of[u]: len(v) for u, v in interrupted.items()},
                            wave={name_of[u]: v for u, v in timing.items()},
                            published_s=t0 - t_wave)
        log(f"  fleet up {stats['fleet_up_s']:.1f} s; v1 raw fanout (chain origin -> S0 -> S1 -> "
            f"S2, {total / 1e9:.3f} GB, {row['n_chunks']} chunks) landed in "
            f"{stats['fanout_s']:.2f} s (manager sync_s {row['sync_s']:.2f}); per hop "
            f"{hops}; origin sent {origin_out} bytes, servers took {from_origin:.0f} from the "
            f"origin and {from_peers:.0f} from peers; in-flight requests interrupted and "
            f"finished on v1 {stats['raw']['interrupted']}; greedy tokens equal the engine's "
            f"on every server; {card}")
        log(f"  the wave against the cutover (s from the wave's start; v1 published at "
            f"{stats['raw']['published_s']:.2f}): " + "; ".join(
                f"{name}: " + ", ".join(
                    f"request {w['index']} sent at {w['start_s']:.2f}, interrupted at "
                    f"{w['reply_s']:.2f} after {w['tokens']} of {sizes['wave_new']} tokens "
                    f"(a whole request {w['wave_s']:.1f})" for w in v)
                for name, v in sorted(stats["raw"]["wave"].items())))
        log(f"  manager /status weight_plane: {json.dumps(row)}")

        # (b) Version 2 on the int8 wire, to S0 from the origin and S1 from S0.
        params = perturbed(torch, params, seed + 22)
        stats["dump_v2"] = dump(params, 2)
        man8 = wc.fetch_manifest(src.address, version=2, wire="int8")
        int8_hops = {}
        for u, ups in ((servers[0], [src.address]), (servers[1], [servers[0], src.address])):
            st, _, d = http_call(u, "/distribute_weights", {
                "version": 2, "manifest": man8, "upstreams": ups, "origin": src.address,
                "deadline_s": PLANE_TIMEOUT_S})
            if st != 200 or not d["success"]:
                raise AssertionError(f"weight_plane: int8 distribute to {name_of[u]}: {st} {d}")
            st, _, c = http_call(u, "/cutover_weights", {"version": 2, "budget_s": 3.0})
            if st != 200 or not c["success"]:
                raise AssertionError(f"weight_plane: int8 cutover on {name_of[u]}: {st} {c}")
            int8_hops[name_of[u]] = dict(
                transfer_ms=d["transfer_ms"], verify_ms=d["verify_ms"],
                cutover_ms=c["cutover_ms"], within_budget=c["within_budget"],
                from_origin=d["bytes_from_origin"], from_peers=d["bytes_from_peers"])
        # The leaves S0 holds, assembled here, against the wire computed here.
        store = wc.ChunkStore(man8)
        t0 = time.perf_counter()
        store.fetch([servers[0]])
        held = wc.assemble_leaves(store)
        assemble_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mismatched = []
        for path, leaf in wt._flatten(params):
            if wt._wire_quantizable(path, leaf):
                want = wt.dequantize_wire_leaf(*wt.quantize_wire_leaf(leaf), "float32")
            else:
                want = leaf.detach().cpu()
            got = held[path]
            if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(
                    got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)):
                mismatched.append(path)
        if mismatched:
            raise AssertionError(f"weight_plane: int8 leaves differ from dequantize_wire_leaf("
                                 f"quantize_wire_leaf(x)): {mismatched[:4]}")
        check_s = time.perf_counter() - t0
        del params
        deq = wt.unflatten_leaves({p: t.to(dev, torch.bfloat16) for p, t in held.items()})
        del held, store
        want2 = greedy_tokens(torch, deq, cfg, reqs, dev, sizes)
        del deq
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        for u in servers[:2]:
            got = greedy_tokens(torch, u, cfg, reqs)
            if {q: ids for q, (ids, _, _) in got.items()} != want2:
                raise AssertionError(f"weight_plane: {name_of[u]}'s int8-wire greedy tokens "
                                     f"differ from the engine's on the dequantized params")
        stats["int8"] = dict(payload_bytes=man8["total_bytes"], n_chunks=man8["n_chunks"],
                             hops=int8_hops, fetch_and_assemble_s=assemble_s,
                             quantize_and_compare_s=check_s)
        log(f"  v2 int8 wire ({man8['total_bytes'] / 1e9:.3f} GB, {man8['n_chunks']} chunks): "
            f"{int8_hops}; the leaves S0 holds equal dequantize_wire_leaf(quantize_wire_leaf(x)) "
            f"bit for bit (fetch + assemble here {assemble_s:.2f} s, quantize + compare "
            f"{check_s:.2f} s); greedy tokens on S0 and S1 "
            f"equal the engine's on them; {card}")

        # Leave: the manager, then the servers, on COMPLETE.
        name_resolve.add(names.experiment_status(exp, trial), "COMPLETE", replace=True)
        for p in procs.values():
            p.join(timeout=180)
        codes = {k: p.exitcode for k, p in procs.items()}
        if any(c != 0 for c in codes.values()):
            raise AssertionError(f"weight_plane: exit codes {codes}")
        records = {}
        for i, c in enumerate(configs):
            with open(exit_record_path(exp, trial, c.worker_name)) as f:
                records[f"S{i}"] = json.load(f)
        after = {k: {n: r["launches"][n] - r["launches_at_cutover"].get(n, 0)
                     for n in r["launches"]} for k, r in records.items()}
        for k, a in after.items():
            for n in ("flash_attn_fwd_bf16", "paged_decode_bf16"):
                if dev.type == "cuda" and a[n] <= 0:
                    raise AssertionError(f"weight_plane: {n} did not launch on {k} after its "
                                         f"cutover")
        launches = {n: sum(r["launches"][n] for r in records.values())
                    for n in records["S0"]["launches"]}
        stats.update(
            launches_after_cutover=after, server_launches=launches,
            peak_memory_gb=dict({k: r["peak_memory_bytes"] / 1e9 for k, r in records.items()},
                                launcher=(torch.cuda.max_memory_allocated(dev) / 1e9
                                          if dev.type == "cuda" else 0.0)),
            host_rss_gb={k: r["max_rss_bytes"] / 1e9 for k, r in records.items()})
        log(f"  peak device memory GB {stats['peak_memory_gb']}; host RSS GB (peak) "
            f"{stats['host_rss_gb']}; launches after the last cutover {after}")
        src.close()
        src = None

        stats["launches"] = dict(launches)
        return stats
    finally:
        if src is not None:
            src.close()
        for p in procs.values():
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


def plane_loop_phase(torch, rng, dev, cfg, seed, card, sizes=PLANE_LOOP_SIZES):
    """The weight_plane phase's part (c), a phase of its own so that it
    can run in the side lane: the async RL loop through
    ``main_async_ppo.main(argv)`` with ``gen_weight_plane=true``, two
    servers at fanout degree 1 on the raw wire (``async_ppo_phase`` with
    ``plane``), at ``sizes`` (max_head_offpolicyness 0): versions 1 and 2
    land on both servers through the plane."""
    log("  the async RL loop with gen_weight_plane=true, two servers, fanout degree 1")
    return async_ppo_phase(torch, rng, dev, cfg, seed, card, sizes=sizes,
                           plane=dict(wire=None))


# ----------------------------------------------------------------------
# Phase 15: supervised fine-tuning through main_sft, saved and served
# ----------------------------------------------------------------------

# The sft phase at real size; a rehearsal on the CPU passes smaller ones.
# The reference's override keys, as a user would pass them.
SFT_SIZES = dict(n_rows=64, prompt=(256, 1024), answer=(128, 512), max_length=2048,
                 train_batch_size=16, steps=3, words=400, row_len=4096,
                 max_tokens_per_mb=16384, lr=1e-4, slots=16, max_seq_len=4096, page=128,
                 chunk=1024, n_greedy=8, greedy_lens=(300, 1200), greedy_new=32)
SFT_TIMEOUT_S = 600.0
# Cut in depth since the recover phase joined the default run (the run's
# time limit): the HF save and the loads move 3.2 GB at 7 layers, not
# 7.1; at 4 since the agentic phase joined.
SFT_LAYERS = 4


def sft_rows(rng, n, sizes, words):
    """`n` prompt/answer rows of seeded words (one token a word under the
    tiny tokenizer)."""
    return [dict(id=f"r{i}", prompt=" ".join(rng.choice(words, _draw(rng, sizes["prompt"]))),
                 answer=" ".join(rng.choice(words, _draw(rng, sizes["answer"]))))
            for i in range(n)]


def sft_phase(torch, rng, dev, cfg, seed, card, sizes=SFT_SIZES):
    """Supervised fine-tuning through the port's entry point,
    areal_tpu_torch.training.main_sft.main(argv), with the reference's
    override keys: a spawned model worker loads the model from an HF
    directory of seeded random weights (bf16 on disk; float32 params,
    bf16 compute, remat) and the prompt/answer jsonl, trains ``steps`` SFT steps, saves the model
    in the HF format at ``exp_ctrl.save_freq_steps`` and answers the
    ``exp_ctrl.eval_freq_steps`` "evaluate" broadcast as the reference's
    worker does (its reply, dropped by the master, is logged). Then the
    save is checked: its config reads back, every leaf is finite and
    moved, ``SFTInterface.evaluate`` over the same rows reads a lower
    ``eval_loss`` on it than on the initial weights, a GenerationServer
    started on it (``model_path``) answers greedy requests over HTTP equal
    to an engine's on the params read back from ``model.safetensors``, and
    a server started on the initial weights takes it through
    ``/update_weights_from_disk`` (``"source": "hf"``) with the same
    tokens."""
    import shutil
    import tempfile

    from areal_tpu_torch import kernels, torch_dtype
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.data_api import (DatasetUtility, PackedDataLoader,
                                              load_hf_tokenizer)
    from areal_tpu_torch.api.model_api import Model, ModelName
    from areal_tpu_torch.api.system_api import GenerationServerConfig
    from areal_tpu_torch.datasets.prompt_answer import PromptAnswerDataset
    from areal_tpu_torch.engine.optimizer import tree_leaves
    from areal_tpu_torch.engine.serving import GenRequest
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
    from areal_tpu_torch.interfaces.sft import SFTInterface
    from areal_tpu_torch.models.hf import load_hf_config, load_hf_model
    from areal_tpu_torch.models.hf.qwen2 import config_from_hf
    from areal_tpu_torch.system import master_worker
    from areal_tpu_torch.system.generation_server import GenerationServer
    from areal_tpu_torch.training import main_sft

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sft_")
    exp, trial = os.path.basename(tmp), "sft"
    fileroot = os.path.join(tmp, "fileroot")
    env = {"AREAL_FILEROOT": fileroot}
    saved_env = {k: os.environ.get(k) for k in env}
    stats = dict(card=card)
    servers = []
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        hf_dir = os.path.join(tmp, "hf")
        words = tiny_tokenizer(rng, hf_dir, sizes["words"])
        # bf16 on disk (half the bytes to write and read); the model worker
        # trains float32 params from it.
        seeded_hf_dir(torch, cfg, seed, dev, hf_dir)
        data = os.path.join(tmp, "sft.jsonl")
        with open(data, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in sft_rows(rng, sizes["n_rows"], sizes,
                                                                 words))
        stats["setup_s"] = time.perf_counter() - t0
        argv = [
            f"experiment_name={exp}", f"trial_name={trial}", f"seed={seed}",
            f"name_resolve_root={os.path.join(tmp, 'name_resolve')}",
            f"model.path={hf_dir}", f"tokenizer_path={hf_dir}",
            f"dataset.path={data}", f"dataset.max_length={sizes['max_length']}",
            f"train_batch_size={sizes['train_batch_size']}",
            f"exp_ctrl.benchmark_steps={sizes['steps']}",
            f"exp_ctrl.save_freq_steps={sizes['steps']}",
            f"exp_ctrl.eval_freq_steps={sizes['steps']}",
            f"model.optimizer.lr={sizes['lr']}", "model.optimizer.warmup_steps_proportion=0.0",
            f"model.row_len_multiple={sizes['row_len']}", f"model.max_row_len={sizes['row_len']}",
            f"mb_spec_max_tokens={sizes['max_tokens_per_mb']}", f"device={dev.type}",
        ]
        log(f"  main_sft {' '.join(argv)}")
        # The master runs in this process: time its save and evaluate
        # broadcasts (each waits for the worker's reply) and keep the replies.
        broadcasts = []
        inner = master_worker.MasterWorker._broadcast

        def timed(self, handle, timeout=3600):
            t = time.perf_counter()
            out = inner(self, handle, timeout)
            broadcasts.append(dict(step=self.step_info.global_step, handle=handle,
                                   seconds=time.perf_counter() - t, replies=out))
            return out

        os.environ.update(env)
        master_worker.MasterWorker._broadcast = timed
        t0 = time.perf_counter()
        try:
            result = main_sft.main(argv, worker_env=env, timeout=SFT_TIMEOUT_S)
        finally:
            master_worker.MasterWorker._broadcast = inner
        stats["run_s"] = time.perf_counter() - t0
        summary = result["perf_summary"]
        steps = [s["trainDefault"] for s in summary["mfc_stats"]]
        if result["global_step"] != sizes["steps"] or len(steps) != sizes["steps"]:
            raise AssertionError(f"sft: {result['global_step']} steps, {len(steps)} reported")
        bad = [k for s in steps for k, v in s.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"sft: non-finite MFC stats {bad}")
        by_handle = {b["handle"]: b for b in broadcasts if b["handle"] != "exit"}
        if sorted(by_handle) != ["evaluate", "save"] or len(broadcasts) != 3:
            raise AssertionError(f"sft: broadcasts {[(b['step'], b['handle']) for b in broadcasts]}")
        if by_handle["save"]["replies"] != [{"ok": True}]:
            raise AssertionError(f"sft: the save replied {by_handle['save']['replies']}")
        log(f"  the worker's reply to the step-{by_handle['evaluate']['step']} \"evaluate\" "
            f"broadcast (the reference's handler passes no eval loader; the master drops "
            f"it): {by_handle['evaluate']['replies']}")

        # The save.
        save_dir = os.path.join(fileroot, "checkpoints", exp, trial, "default",
                                f"step{sizes['steps']}", "dp0")
        missing = {"config.json", "model.safetensors", "tokenizer.json",
                   "tokenizer_config.json"} - set(os.listdir(save_dir))
        if missing:
            raise AssertionError(f"sft: {save_dir} lacks {sorted(missing)}")
        got_cfg = {k: v for k, v in dataclasses.asdict(
            config_from_hf(load_hf_config(save_dir))).items() if not k.endswith("_dtype")}
        want_cfg = {k: v for k, v in dataclasses.asdict(cfg).items()
                    if not k.endswith("_dtype")}
        if got_cfg != want_cfg:
            raise AssertionError(f"sft: the saved config reads {got_cfg}, want {want_cfg}")
        stats["save_bytes"] = sum(os.path.getsize(os.path.join(save_dir, f))
                                  for f in os.listdir(save_dir))
        stats["save_s"] = by_handle["save"]["seconds"]
        # The model learnt: eval_loss on the same rows, initial against
        # saved, each model on the card in an engine of its own.
        tok = load_hf_tokenizer(hf_dir)
        dataset = PromptAnswerDataset(DatasetUtility(seed=seed, tokenizer=tok),
                                      sizes["max_length"], data)
        loader = PackedDataLoader(dataset, batch_size=sizes["train_batch_size"], shuffle=False)
        batches = [loader.next_batch()[0] for _ in range(len(loader))]
        # The tokens each step trained on: the model worker's loader, replayed.
        loader = PackedDataLoader(dataset, batch_size=sizes["train_batch_size"], seed=seed)
        step_tokens = [loader.next_batch()[0].total_seqlen() for _ in steps]
        evals, engines = {}, {}
        for name, path in (("initial", hf_dir), ("saved", save_dir)):
            t0 = time.perf_counter()
            ecfg, eparams = load_hf_model(path)
            load_s = time.perf_counter() - t0
            engines[name] = TorchTrainEngine(ecfg, eparams, remat="none",
                                             row_len_multiple=sizes["row_len"],
                                             max_row_len=sizes["row_len"], device=dev)
            del eparams
            evals[name] = SFTInterface().evaluate(
                Model(name=ModelName("default", 0), module=engines[name], tokenizer=tok),
                batches)
            evals[name].update(seconds=time.perf_counter() - t0, host_load_s=load_s)
        stats["eval"] = evals
        if not evals["saved"]["eval_loss"] < evals["initial"]["eval_loss"]:
            raise AssertionError(f"sft: eval_loss did not fall: {evals}")
        # The saved weights: every leaf finite and moved from the initial one.
        saved_cfg = engines["saved"].model_cfg
        trained = engines["saved"].get_params()
        init = engines.pop("initial").get_params()
        names_ = leaf_paths(trained)
        if names_ != leaf_paths(init):
            raise AssertionError("sft: the saved tree differs from the initial one")
        still = [k for k, a, b in zip(names_, tree_leaves(trained), tree_leaves(init))
                 if torch.equal(a, b)]
        nonfinite = [k for k, a in zip(names_, tree_leaves(trained))
                     if not torch.isfinite(a).all()]
        if still or nonfinite:
            raise AssertionError(f"sft: leaves that did not move {still}, non-finite "
                                 f"{nonfinite}")
        del init
        # As the servers will hold them: the saved params in the compute
        # dtype, kept on the host while the servers run so that their peak
        # device memory is their own.
        with torch.no_grad():
            trained = cast_tree(trained, torch_dtype(saved_cfg.compute_dtype),
                                device=torch.device("cpu"))
        engines.clear()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # Serving the save: from model_path, and through a weight update.
        eos = tok.eos_token_id
        reqs = [GenRequest(qid=f"sft{i}", max_new_tokens=sizes["greedy_new"], greedy=True,
                           input_ids=rng.integers(0, cfg.vocab_size,
                                                  _draw(rng, sizes["greedy_lens"])).tolist())
                for i in range(sizes["n_greedy"])]
        serve_kw = dict(max_concurrent_requests=sizes["slots"], max_seq_len=sizes["max_seq_len"],
                        kv_page_size=sizes["page"], decode_block_steps=16,
                        prefill_chunk=sizes["chunk"], seed=seed, device=str(dev))

        def start_server(index, model_path):
            gcfg = GenerationServerConfig(
                experiment_name=exp, trial_name="serve", server_index=index,
                model=ModelAbstraction("tpu_transformer", args={}), model_path=model_path,
                **serve_kw)
            server = GenerationServer()
            t = time.perf_counter()
            server.configure(gcfg, experiment_name=exp, trial_name=gcfg.trial_name,
                             worker_name=gcfg.worker_name)
            run = threading.Thread(target=server.run, daemon=True)
            run.start()
            servers.append((server, run))
            return server, time.perf_counter() - t

        def over_http(url):
            return {q: ids for q, (ids, _, _) in
                    greedy_tokens(torch, url, None, reqs, phase="sft").items()}

        def stop(server):
            server.exit()
            for s, run in servers:
                if s is server:
                    run.join(timeout=120)
            servers[:] = [(s, r) for s, r in servers if s is not server]
            if dev.type == "cuda":
                torch.cuda.empty_cache()

        # Each server's peak device memory: the process's peak while it
        # runs, less what the process held before it started.
        held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        stats["held_gb"] = held / 1e9
        stats["server_peak_gb"] = {}

        def peak_reset():
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)

        def peak_read(name):
            stats["server_peak_gb"][name] = (
                (torch.cuda.max_memory_allocated(dev) - held) / 1e9 if dev.type == "cuda"
                else 0.0)

        kernels.reset_launches()
        peak_reset()
        server, stats["server_start_s"] = start_server(0, save_dir)
        from_path = over_http(server.address)
        stop(server)
        peak_read("model_path")
        peak_reset()
        server, _ = start_server(1, hf_dir)
        status, _, upd = http_call(server.address, "/update_weights_from_disk",
                                   {"model_path": save_dir, "allow_interrupt": True})
        if status != 200 or not upd.get("success") or upd["source"] != "hf":
            raise AssertionError(f"sft: weight update from the save: {status} {upd}")
        from_update = over_http(server.address)
        stop(server)
        peak_read("update")
        server_counts = dict(kernels.launches)

        direct = greedy_tokens(torch, cast_tree(trained, None, device=dev), saved_cfg, reqs,
                               dev, sizes, eos_token_id=eos, phase="sft")
        del trained
        if from_path != direct or from_update != direct:
            raise AssertionError(
                f"sft: greedy tokens differ from the engine's on the saved params: from "
                f"model_path {sum(from_path[q] == direct[q] for q in direct)}/{len(direct)}, "
                f"through the update {sum(from_update[q] == direct[q] for q in direct)}/"
                f"{len(direct)} equal")

        worker_counts = {k: int(sum(s.get(f"launches/{k}", 0) for s in steps))
                         for k in server_counts}
        if dev.type == "cuda":
            for k in ("flash_attn_fwd_bf16", "flash_attn_bwd_dq_bf16",
                      "flash_attn_bwd_dkv_bf16"):
                if worker_counts[k] <= 0:
                    raise AssertionError(f"sft: kernel {k} was not launched in the model worker")
            for k in ("flash_attn_fwd_bf16", "paged_decode_bf16"):
                if server_counts[k] <= 0:
                    raise AssertionError(f"sft: kernel {k} was not launched by the servers")
        n_resp = [s["sft/n_tokens"] for s in steps]
        e2e = [h[0] for h in summary["history"]]
        stats.update(
            step_e2e_s=e2e, mfc_sec=[s["perf/sec"] for s in steps], step_tokens=step_tokens,
            response_tokens=n_resp,
            train_tok_per_s=[n / s["perf/sec"] for n, s in zip(step_tokens, steps)],
            loss=[s["sft/loss"] for s in steps], eval_s=by_handle["evaluate"]["seconds"],
            load_s=upd["load_s"],
            worker_peak_gb=max(s["perf/mem_peak_bytes_in_use"] for s in steps) / 1e9,
            server_launches=server_counts, worker_launches=worker_counts,
            launches={k: worker_counts[k] + server_counts[k] for k in worker_counts},
            greedy_tokens=sum(map(len, direct.values())))
        stats["phase_s"] = time.perf_counter() - t_phase
        log(f"  {sizes['steps']} SFT steps through main_sft in {stats['run_s']:.1f} s (worker "
            f"start, HF load, steps, save, evaluate, exit): step e2e "
            f"{[round(x, 3) for x in e2e]} s, MFC perf/sec "
            f"{[round(x, 3) for x in stats['mfc_sec']]} s, tokens {step_tokens} (loss tokens "
            f"{[int(x) for x in n_resp]}), train tokens/s "
            f"{[round(x, 1) for x in stats['train_tok_per_s']]}, loss "
            f"{[round(x, 4) for x in stats['loss']]}; worker peak device memory "
            f"{stats['worker_peak_gb']:.2f} GB; {card}")
        log(f"  HF save of step {sizes['steps']}: {stats['save_s']:.2f} s for "
            f"{stats['save_bytes']} bytes ({stats['save_bytes'] / stats['save_s'] / 1e9:.2f} "
            f"GB/s, the master's wait on the broadcast); evaluate broadcast "
            f"{stats['eval_s']:.3f} s; eval_loss initial {evals['initial']['eval_loss']:.5f}, "
            f"saved {evals['saved']['eval_loss']:.5f} over {evals['saved']['eval_n_tokens']:.0f} "
            f"response tokens ({evals['initial']['seconds']:.1f} / "
            f"{evals['saved']['seconds']:.1f} s with the load)")
        log(f"  servers: started on the save in {stats['server_start_s']:.1f} s; the update "
            f"from the save load_s {stats['load_s']:.3f} (source hf); {len(reqs)} greedy "
            f"requests over HTTP equal the engine's on the saved params both ways "
            f"({stats['greedy_tokens']} tokens); peak device memory of each server (GB, "
            f"beyond the {stats['held_gb']:.2f} GB this process held before) "
            f"{ {k: round(v, 2) for k, v in stats['server_peak_gb'].items()} }; launches in "
            f"the model worker {worker_counts}, "
            f"in the servers {server_counts}; phase wall {stats['phase_s']:.1f} s; {card}")
        return stats
    finally:
        for server, run in servers:
            server.exit()
            run.join(timeout=120)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


RECOVER_SIZES = dict(n_rows=96, prompt=(256, 1024), answer=(128, 512), max_length=2048,
                     train_batch_size=16, steps=5, ckpt_steps=2, fail_at=4, words=400,
                     row_len=4096, max_tokens_per_mb=16384, lr=1e-4)
RECOVER_TIMEOUT_S = 600.0
# Cut in depth for the run's time limit: two worker starts, two
# checkpoints and a restore, at 7 layers when it joined and at 4 since
# the agentic phase joined the default run.
RECOVER_LAYERS = 4
RECOVER_KERNELS = ("flash_attn_fwd_bf16", "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16")


def snapshot_stalls(torch, dev, cfg, params, save_dir):
    """On an engine of the recover phase's depth (float32 params and
    AdamW moments on the card): the step-loop stall of a synchronous
    save_engine_state, and what a snapshot into pinned host memory would
    cost the loop (allocating the pinned buffers, then the copy the next
    in-place step must wait for), beside the device clone the async
    writer takes."""
    from areal_tpu_torch.engine import checkpoint
    from areal_tpu_torch.engine.optimizer import OptimizerConfig, tree_leaves
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine

    eng = TorchTrainEngine(cfg, cast_tree(params, torch.float32), optimizer_config=OptimizerConfig(),
                           device=dev)
    state = tree_leaves(eng.params) + eng.optimizer.mu + eng.optimizer.nu
    nbytes = sum(x.numel() * x.element_size() for x in state)
    out = dict(state_bytes=nbytes)
    saved = os.environ.pop("AREAL_CKPT_ASYNC", None)
    try:
        sync(torch, dev)
        t = time.perf_counter()
        checkpoint.save_engine_state(eng, save_dir)
        out["sync_stall_ms"] = checkpoint.ckpt_stats["areal:train_ckpt_stall_ms"]
        out["sync_wall_s"] = time.perf_counter() - t
    finally:
        if saved is not None:
            os.environ["AREAL_CKPT_ASYNC"] = saved
    sync(torch, dev)
    t = time.perf_counter()
    clone = [x.detach().clone() for x in state]
    sync(torch, dev)
    out["clone_ms"] = (time.perf_counter() - t) * 1e3
    del clone
    t = time.perf_counter()
    host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in state]
    out["pin_alloc_ms"] = (time.perf_counter() - t) * 1e3
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    t = time.perf_counter()
    with torch.cuda.stream(side):
        for h, x in zip(host, state):
            h.copy_(x, non_blocking=True)
    side.synchronize()
    out["pin_copy_ms"] = (time.perf_counter() - t) * 1e3
    del host, state, eng
    torch.cuda.empty_cache()
    return out


def recover_phase(torch, rng, dev, cfg, seed, card, sizes=RECOVER_SIZES):
    """Checkpoint and recovery through the port's entry point,
    areal_tpu_torch.training.main_sft.main(argv), with the reference's
    override keys: the master of the first incarnation fails at the top
    of step ``fail_at`` (after step ``fail_at - 1``'s stats, before any
    checkpoint of that step), the launcher's loop relaunches with
    recover_mode=auto, and the second incarnation resumes from the
    checkpoint of step ``ckpt_steps``. See the module docstring for the
    gates."""
    import shutil
    import tempfile

    from areal_tpu_torch.base import recover
    from areal_tpu_torch.base.fault_injection import faults
    from areal_tpu_torch.engine import checkpoint
    from areal_tpu_torch.models.hf import load_hf_model
    from areal_tpu_torch.system import master_worker
    from areal_tpu_torch.system.function_executor import FunctionExecutor
    from areal_tpu_torch.system.worker_base import exit_record_path
    from areal_tpu_torch.training import main_sft

    tmp = tempfile.mkdtemp(prefix="chip_smoke_recover_")
    exp, trial = os.path.basename(tmp), "recover"
    fileroot = os.path.join(tmp, "fileroot")
    env = {"AREAL_FILEROOT": fileroot}
    worker_env = dict(env, AREAL_CKPT_ASYNC="1")
    saved_env = {k: os.environ.get(k) for k in env}
    stats = dict(card=card)
    Master = master_worker.MasterWorker
    inner = dict(configure=Master._configure, broadcast=Master._broadcast,
                 recover=Master._maybe_recover, step=FunctionExecutor.execute_step_sync)
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        hf_dir = os.path.join(tmp, "hf")
        words = tiny_tokenizer(rng, hf_dir, sizes["words"])
        seeded_hf_dir(torch, cfg, seed, dev, hf_dir)
        # Kept (bf16) for the in-process engine of the stall measurements.
        params = cast_tree(load_hf_model(hf_dir)[1], torch.bfloat16, dev)
        data = os.path.join(tmp, "sft.jsonl")
        with open(data, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in sft_rows(rng, sizes["n_rows"], sizes,
                                                                 words))
        stats["setup_s"] = time.perf_counter() - t0
        argv = [
            f"experiment_name={exp}", f"trial_name={trial}", f"seed={seed}",
            f"name_resolve_root={os.path.join(tmp, 'name_resolve')}",
            f"model.path={hf_dir}", f"tokenizer_path={hf_dir}",
            f"dataset.path={data}", f"dataset.max_length={sizes['max_length']}",
            f"train_batch_size={sizes['train_batch_size']}",
            f"exp_ctrl.benchmark_steps={sizes['steps']}",
            f"exp_ctrl.ckpt_freq_steps={sizes['ckpt_steps']}",
            "recover_mode=auto", "recover_retries=1",
            f"model.optimizer.lr={sizes['lr']}", "model.optimizer.lr_scheduler_type=constant",
            "model.optimizer.warmup_steps_proportion=0.0",
            f"model.row_len_multiple={sizes['row_len']}", f"model.max_row_len={sizes['row_len']}",
            f"mb_spec_max_tokens={sizes['max_tokens_per_mb']}", f"device={dev.type}",
        ]
        log(f"  main_sft {' '.join(argv)} (worker env {worker_env})")
        os.environ.update(env)
        ckpt_dir = os.path.join(fileroot, "recover", exp, trial, "default", "dp0")
        record = exit_record_path(exp, trial, "model_worker/0")
        attempts, steps, broadcasts, restores, t_fail = [], [], [], [], []

        # The master runs in this process: what each incarnation finds on
        # disk at its start, its "ckpt" broadcasts, its restore and steps.
        def configure(self, config):
            a = dict(mode=config.recover_mode, t=time.perf_counter())
            if attempts:
                a["record_step"] = recover.load(exp, trial).last_step_info.global_step
                a["manifest"] = checkpoint.load_manifest(ckpt_dir)
                with open(record) as f:
                    a["worker"] = json.load(f)
            attempts.append(a)
            return inner["configure"](self, config)

        def broadcast(self, handle, timeout=3600):
            t = time.perf_counter()
            out = inner["broadcast"](self, handle, timeout)
            broadcasts.append(dict(attempt=len(attempts), step=self.step_info.global_step,
                                   handle=handle, seconds=time.perf_counter() - t))
            return out

        def maybe_recover(self):  # the relaunch's wait on "restore"
            t = time.perf_counter()
            inner["recover"](self)
            restores.append(time.perf_counter() - t)

        def step(self):
            out = inner["step"](self)
            steps.append(dict(attempt=len(attempts), t=time.perf_counter(),
                              stats=out["trainDefault"]))
            return out

        Master._configure, Master._broadcast, Master._maybe_recover = (
            configure, broadcast, maybe_recover)
        FunctionExecutor.execute_step_sync = step
        faults.reset()
        faults.arm("master.step", "raise", at_hit=sizes["fail_at"],
                   on_trigger=lambda: t_fail.append(time.perf_counter()))
        t0 = time.perf_counter()
        try:
            result = main_sft.main(argv, worker_env=worker_env, timeout=RECOVER_TIMEOUT_S)
        finally:
            faults.reset()
            Master._configure, Master._broadcast, Master._maybe_recover = (
                inner["configure"], inner["broadcast"], inner["recover"])
            FunctionExecutor.execute_step_sync = inner["step"]
        stats["run_s"] = time.perf_counter() - t0
        with open(record) as f:
            final_worker = json.load(f)
        final_record = recover.load(exp, trial).last_step_info.global_step
        final_manifest = checkpoint.load_manifest(ckpt_dir)
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, "engine_state.pkl"))
        litter = [f for f in os.listdir(ckpt_dir) if ".tmp." in f]

        # (a) one relaunch; (b) the record and manifest it resumed from, and
        # the record at the end.
        if len(attempts) != 2 or result["global_step"] != sizes["steps"]:
            raise AssertionError(f"recover: {len(attempts)} incarnations, global step "
                                 f"{result['global_step']}")
        a2 = attempts[1]
        want_vs = sizes["ckpt_steps"]
        if (a2["record_step"] != sizes["ckpt_steps"] or a2["manifest"] is None
                or a2["manifest"]["schema"] != "areal-train-ckpt/v1"
                or a2["manifest"]["version_steps"] != want_vs or final_record != sizes["steps"]):
            raise AssertionError(f"recover: the relaunch found record step "
                                 f"{a2['record_step']}, manifest {a2['manifest']}; the "
                                 f"record ends at {final_record}")
        # Incarnation 1 trains steps 1 .. fail_at - 1; incarnation 2 resumes
        # at global step ckpt_steps + 1 and trains to `steps`, its first
        # step on step ckpt_steps + 1's batch.
        by = {i: [s for s in steps if s["attempt"] == i] for i in (1, 2)}
        n1, n2 = sizes["fail_at"] - 1, sizes["steps"] - sizes["ckpt_steps"] - 1
        if len(by[1]) != n1 or len(by[2]) != n2 or n1 != sizes["ckpt_steps"] + 1:
            raise AssertionError(f"recover: steps {len(by[1])} then {len(by[2])}, want {n1} "
                                 f"then {n2}")
        # (c) the repeated step.
        sft = lambda st: {k: v for k, v in st.items() if k.startswith("sft/")}  # noqa: E731
        before, after = sft(by[1][n1 - 1]["stats"]), sft(by[2][0]["stats"])
        diff = {k: abs(after[k] - before[k]) / max(abs(before[k]), 1e-30) for k in before}
        stats["repeat_rel_diff"] = diff
        if after != before:
            raise AssertionError(f"recover: step {n1} after the restore differs: {before} "
                                 f"against {after}")
        # (d) the kernels in each incarnation.
        launches = {i: {k: int(sum(s["stats"].get(f"launches/{k}", 0) for s in by[i]))
                        for k in RECOVER_KERNELS} for i in (1, 2)}
        if dev.type == "cuda":
            bad = [(i, k) for i in (1, 2) for k in RECOVER_KERNELS if launches[i][k] <= 0]
            if bad:
                raise AssertionError(f"recover: kernels not launched {bad}")
        # (e) no pending write at either exit; the final checkpoint committed.
        w1, w2 = a2["worker"], final_worker
        if (any((w["ckpt_writer"] or {}).get("pending") != 0 for w in (w1, w2)) or litter
                or final_manifest["rng"]["train_calls"] != want_vs + n2):
            raise AssertionError(f"recover: writers {w1['ckpt_writer']} {w2['ckpt_writer']}, "
                                 f"litter {litter}, final manifest {final_manifest}")

        ckpts = [b for b in broadcasts if b["handle"] == "ckpt"]
        stats.update(
            ckpt_bytes=ckpt_bytes, ckpt_broadcast_s=[b["seconds"] for b in ckpts],
            ckpt_steps=[(b["attempt"], b["step"]) for b in ckpts],
            worker_stall_ms=[c["stall_ms"] for w in (w1, w2) for c in w["ckpt"]],
            write_s=[w1["ckpt_writer"]["last_write_s"], w2["ckpt_writer"]["last_write_s"]],
            write_host_s=[w1["ckpt_writer"]["last_host_s"], w2["ckpt_writer"]["last_host_s"]],
            step_s={i: [s["stats"]["perf/sec"] for s in by[i]] for i in (1, 2)},
            restore_s=restores[-1], worker_restore_s=w2["restore_s"],
            time_to_recover_s=by[2][0]["t"] - t_fail[0],
            relaunch_to_restored_s=a2["t"] - t_fail[0],
            worker_peak_gb=[w1["peak_memory_bytes"] / 1e9, w2["peak_memory_bytes"] / 1e9],
            step_e2e_s=[h[0] for h in result["perf_summary"]["history"]],
            launches_by_incarnation=launches,
            launches={k: launches[1][k] + launches[2][k] for k in RECOVER_KERNELS})
        stats["write_gb_s"] = [ckpt_bytes / s / 1e9 for s in stats["write_s"]]
        log(f"  main_sft with one failure in {stats['run_s']:.1f} s: incarnation 1 steps 1-{n1} "
            f"(checkpoint at step {sizes['ckpt_steps']}), failed at the top of step "
            f"{sizes['fail_at']}; the relaunch found the recover record at step "
            f"{a2['record_step']} and the manifest {a2['manifest']['schema']} (version_steps "
            f"{a2['manifest']['version_steps']}); incarnation 2 trained {n2} steps, step "
            f"{n1} again bit-equal in every sft/* stat; the record ends at {final_record}")
        log(f"  checkpoint {ckpt_bytes} bytes; trainer stall: the ckpt broadcast "
            f"{[round(x, 4) for x in stats['ckpt_broadcast_s']]} s, the worker's "
            f"areal:train_ckpt_stall_ms {[round(x, 2) for x in stats['worker_stall_ms']]}; "
            f"the writer {[round(x, 2) for x in stats['write_s']]} s "
            f"({[round(x, 3) for x in stats['write_gb_s']]} GB/s; the host copy "
            f"{[round(x, 2) for x in stats['write_host_s']]} s of it, then pickle and fsync); "
            f"MFC seconds by incarnation {({i: [round(x, 3) for x in v] for i, v in stats['step_s'].items()})} "
            f"(step {sizes['ckpt_steps'] + 1} of the first runs while the step-"
            f"{sizes['ckpt_steps']} write is in flight); "
            f"restore {stats['restore_s']:.2f} s (the master's wait; the worker's load "
            f"{stats['worker_restore_s']:.2f} s); time to recover {stats['time_to_recover_s']:.1f} "
            f"s (the failure to step {n1}'s stats again; {stats['relaunch_to_restored_s']:.1f} s "
            f"of it to the relaunched master's start); worker peak device memory "
            f"{[round(x, 2) for x in stats['worker_peak_gb']]} GB with the snapshot; launches "
            f"{launches}; step e2e {[round(x, 3) for x in stats['step_e2e_s']]} s; {card}")
        shutil.rmtree(fileroot, ignore_errors=True)
        if dev.type == "cuda":
            stats["in_process"] = ip = snapshot_stalls(torch, dev, cfg, params,
                                                        os.path.join(tmp, "sync"))
            log(f"  in this process, {ip['state_bytes']} bytes of params and moments: a "
                f"synchronous save stalls the step loop {ip['sync_stall_ms']:.1f} ms; the async "
                f"writer's device clone takes {ip['clone_ms']:.2f} ms; a snapshot into pinned "
                f"host memory would take {ip['pin_alloc_ms']:.1f} ms to allocate and "
                f"{ip['pin_copy_ms']:.1f} ms to copy; {card}")
        del params
        stats["phase_s"] = time.perf_counter() - t_phase
        return stats
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Phase 17: async PPO on agentic episodes (async_ppo_phase with agentic)
# ----------------------------------------------------------------------

# The agentic phase at real size; a rehearsal on the CPU passes smaller
# ones. Three turns an episode: turn 0 calls python, turn 1 the
# calculator, turn 2 answers. `window` is the agentic staleness window.
AGENTIC_SIZES = dict(n_prompts=32, prompt=(256, 768), train_batch_size=8, max_new_tokens=128,
                     turns=3, tool_turns=2, offpolicy=1, window=1, steps=2, slots=16,
                     max_seq_len=4096, row_len=4096, max_tokens_per_mb=16384, n_minibatches=4,
                     words=400, executors=2, exec_workers=2)
AGENTIC_TIMEOUT_S = 600.0
# Cut in depth for the run's time limit, as the other loops: to 7, then
# to 4 when the fleet phase joined.
AGENTIC_LAYERS = 4


def start_executors(tmp, exp, trial, nr_root, n, workers):
    """`n` reward executors (``python -m areal_tpu_torch.system.reward_executor``,
    `workers` warm sandboxes each) on the run's name_resolve root,
    executor 0 armed to die on its first submit; returns the processes
    and their URLs once every one has registered."""
    from areal_tpu_torch.base import name_resolve, names

    procs = []
    for i in range(n):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p),
            AREAL_HEALTH_TTL="2", CUDA_VISIBLE_DEVICES="")
        if i == 0:
            env["AREAL_FAULTS"] = "rexec.die=die"
        with open(os.path.join(tmp, f"rexec{i}.log"), "w") as log_f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "areal_tpu_torch.system.reward_executor",
                 "--experiment", exp, "--trial", trial, "--index", str(i),
                 "--workers", str(workers), "--name-resolve-root", nr_root],
                env=env, cwd=ROOT, stdin=subprocess.DEVNULL, stdout=log_f,
                stderr=subprocess.STDOUT))
    name_resolve.reconfigure("nfs", record_root=nr_root)
    urls, deadline = {}, time.monotonic() + 120
    while len(urls) < n and time.monotonic() < deadline:
        for i in range(n):
            try:
                urls[i] = name_resolve.get(names.reward_executor_url(exp, trial, str(i)))
            except name_resolve.NameEntryNotFoundError:
                pass
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.2)
    if len(urls) < n:
        stop_processes(procs)
        raise AssertionError(f"agentic: only executors {sorted(urls)} of {n} registered")
    return procs, urls


def stop_processes(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def rexec_metrics(url):
    """The executor's /metrics lines as {name: value}."""
    _status, _headers, body = http_raw(url + "/metrics", timeout=30)
    return {k: float(v) for k, v in (line.split() for line in body.decode().splitlines() if line)}


def turn_reprefill(spans):
    """Each turn's re-prefill tokens an episode, from the rollout worker's
    gen.chunk spans: per qid in start order, a chunk that is no
    continuation opens turn 0, a continuation chunk that re-prefilled less
    than its whole prompt opens the next turn, and a resubmission (an
    interrupted chunk, which re-prefills everything) adds to the turn it
    interrupted. Returns {turn: [tokens an episode]}."""
    by_qid = {}
    for r in spans:
        a = r.get("attrs") or {}
        if r["name"] == "gen.chunk" and "reprefill_tokens" in a:
            by_qid.setdefault(a["qid"], []).append((r["start_ns"], a))
    out = {}
    for chunks in by_qid.values():
        turns = []
        for _, a in sorted(chunks, key=lambda c: c[0]):
            if not turns or (a["continuation"]
                             and a["reprefill_tokens"] < a["full_prefill_tokens"]):
                turns.append(0)
            turns[-1] += a["reprefill_tokens"]
        for t, n in enumerate(turns):
            out.setdefault(t, []).append(n)
    return out


def agentic_gates(stats, sizes, steps, rollout, srv, survivor):
    """The agentic phase's own readings and gates, on what async_ppo_phase
    read: the actor stats, the rollout worker's episodes, tool
    observations and chunks, the surviving executor's /metrics and the
    server's exit record. Every reading is logged before any gate."""
    n_trained = sizes["steps"] * sizes["train_batch_size"]
    turns = [s.get("perf/episode_turns") for s in steps]
    calls = [s.get("perf/episode_tool_calls") for s in steps]
    failed = [r for r in rollout if r["name"] == "rollout.episode"
              and (r.get("attrs") or {}).get("failed")]
    py_obs = [r["attrs"]["obs"] for r in rollout
              if r["name"] == "tool.result" and r["attrs"]["tool"] == "python"]
    errors = [o for o in py_obs if o.startswith("error:")]
    cont = [r["attrs"] for r in rollout if r["name"] == "gen.chunk"
            and (r.get("attrs") or {}).get("continuation")
            and "reprefill_tokens" in r["attrs"]]
    reprefill = sum(a["reprefill_tokens"] for a in cont)
    full = sum(a["full_prefill_tokens"] for a in cont)
    hits = srv["metrics"]["prefix_cache_hits"]
    per_turn = turn_reprefill(rollout)
    stale = [s.get("perf/task_staleness_agentic") for s in steps]
    lp_diff = steps[0]["ppo_actor_first_mb/abs_logprob_diff"]
    exec0_exit = stats["executor0_exit"]
    stats.update(
        episode_turns=turns, tool_calls=calls,
        episodes_per_s=n_trained / stats["run_s"], python_observations=len(py_obs),
        continuation_reprefill=reprefill, continuation_full_prefill=full,
        reprefill_tokens_steps=[s.get("perf/reprefill_tokens") for s in steps],
        turn_reprefill_median={t: float(np.median(v)) for t, v in sorted(per_turn.items())},
        prefix_cache_hits=hits, prefix_tokens_reused=srv["metrics"]["prefix_tokens_reused"],
        task_staleness_agentic=stale,
        stale_dropped=[s.get("perf/task_stale_dropped_agentic", 0.0) for s in steps],
        abs_logprob_diff_step1_mb1=lp_diff,
        importance_weight_step1_mb1=steps[0]["ppo_actor_first_mb/importance_weight"],
        executor_survivor={k.split(":")[1]: v for k, v in survivor.items()})
    log(f"  {n_trained} trained tool-use episodes, {stats['episodes_per_s']:.3f} episodes/s "
        f"over the run (executors up in {stats['executors_start_s']:.1f} s); {stats['card']}")
    log(f"  turns {turns}, tool calls {calls} a step; {len(failed)} failed episodes; "
        f"{len(py_obs)} python observations {sorted(set(py_obs))[:3]}; the reward "
        f"executors: executor 0 exit {exec0_exit}, the survivor ran "
        f"{survivor['areal:rexec_jobs_total']:.0f} jobs "
        f"({survivor['areal:rexec_job_failures']:.0f} failed, "
        f"{survivor['areal:rexec_worker_respawns']:.0f} respawns, "
        f"{survivor['areal:rexec_warm_hits']:.0f} warm hits, "
        f"{survivor['areal:rexec_shed_total']:.0f} sheds)")
    log(f"  continuation chunks re-prefilled {reprefill} of their {full} prompt tokens; "
        f"median re-prefill an episode by turn {stats['turn_reprefill_median']}; "
        f"perf/reprefill_tokens by step {stats['reprefill_tokens_steps']}; prefix-cache "
        f"hits {hits:.0f}, tokens reused {stats['prefix_tokens_reused']:.0f}; mean "
        f"perf/task_staleness_agentic by step {stale} (window {sizes['window']}), dropped "
        f"{stats['stale_dropped']}")
    log(f"  step 1's first minibatch, the generator's logprobs of the concatenated turns "
        f"against the training forward's: mean |difference| {lp_diff:.6f} (limit "
        f"{SYNC_LP_TOL}), importance weight {stats['importance_weight_step1_mb1']:.6f}")

    # (2) every trained episode ran its turns and tool calls, none
    # failed, and the python tool answered 42.
    if (turns != [float(sizes["turns"])] * sizes["steps"]
            or calls != [float(sizes["tool_turns"])] * sizes["steps"] or failed
            or len(py_obs) < n_trained or any(o.strip() != "42" for o in py_obs)):
        raise AssertionError(f"agentic: turns {turns}, tool calls {calls}, failed episodes "
                             f"{len(failed)}, python observations {sorted(set(py_obs))[:5]} "
                             f"({len(py_obs)})")
    # (3) executor 0 died, the survivor took the tool traffic.
    if exec0_exit is None or survivor["areal:rexec_jobs_total"] < n_trained or errors:
        raise AssertionError(f"agentic: executor 0 exit code {exec0_exit}, survivor "
                             f"{survivor}, python errors {errors[:3]}")
    # (4) continuations re-prefill only their deltas.
    if not cont or not reprefill < 0.5 * full or hits <= 0:
        raise AssertionError(f"agentic: continuation chunks {len(cont)} re-prefilled "
                             f"{reprefill} of {full} tokens; prefix-cache hits {hits}")
    # (6) step 1's first minibatch: the generator's logprobs of the
    # concatenated turns against the training forward's.
    if not lp_diff <= SYNC_LP_TOL:
        raise AssertionError(f"agentic: step 1's first minibatch: the generator's logprobs "
                             f"differ from the training forward's by {lp_diff:.6f} a token "
                             f"on average, past {SYNC_LP_TOL}")


def cast_tree(tree, dtype, device=None):
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def kernel_entry_name(mangled: str) -> str:
    """A kernel's name and template arguments (integers, bools, bf16 and
    int8 types) read off its mangled name (paged_split_kernel<bf16, 128,
    8>), else the mangled name."""
    m = re.search(r"\d([A-Za-z][A-Za-z_]*_kernel)I((?:13__nv_bfloat16|a|L[ib]\d+E)+)E",
                  mangled)
    if not m:
        return mangled
    args = []
    for tok, kind, val in re.findall(r"(13__nv_bfloat16|a|L([ib])(\d+)E)", m.group(2)):
        if kind:
            args.append(("false", "true")[int(val)] if kind == "b" else val)
        else:
            args.append("bf16" if tok.startswith("13") else "int8")
    return f"{m.group(1)}<{', '.join(args)}>"


# Phases that run in a second process, the side lane, beside the phases
# of SIDE_LANE_BESIDE (which run here meanwhile), to keep the default
# run inside its limit. Each of the seven spawns its own workers, reads
# only its own temp dirs and holds no gate on a time, and their peaks on
# the card sum to well under its memory; parity, the serving phases,
# disagg, weight_plane and fleet, whose readings or gates hang on
# timing, run alone. The step and fanout times of the seven are read
# with the other lane running. --serial runs every phase here, in order.
SIDE_LANE = ("recover", "agentic", "plane_loop")
SIDE_LANE_BESIDE = ("workers", "async_ppo", "sync_ppo", "sft")
# Side lanes started and not yet joined: a run that fails first prints
# their logs to stderr.
_OPEN_LANES = []


def log_plane_loop(report, card):
    """The loop over the plane beside the async_ppo phase's disk path."""
    loop = report["phases"]["plane_loop"]
    disk = report["phases"].get("async_ppo")
    log(f"  the loop over the plane ({PLANE_LOOP_LAYERS} layers): step e2e "
        f"{[round(x, 3) for x in loop['step_e2e_s']]} s, fanouts "
        f"{[round(x, 3) for x in loop['last_weight_sync_s']]} s, dumps "
        f"{[round(x, 2) for x in loop['dump_s']]} s"
        + (f"; the async_ppo phase's disk path ({ASYNC_LAYERS} layers) in this run: step "
           f"e2e {[round(x, 3) for x in disk['step_e2e_s']]} s, fanouts "
           f"{[round(x, 3) for x in disk['last_weight_sync_s']]} s" if disk else "")
        + f"; {card}")


def start_side_lane(args, side):
    """`python3 chip_smoke.py --serial --phases build,<side>` in a child
    process, its report to a temp file and its stdout to another."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_side_")
    out, text = os.path.join(tmp, "report.json"), os.path.join(tmp, "stdout.txt")
    cmd = [sys.executable, os.path.abspath(__file__), "--serial", "--budget-s", "0",
           "--seed", str(args.seed), "--phases", ",".join(["build", *side]), "--out", out]
    log(f"side lane: {' '.join(side)} in a second process beside "
        f"{' '.join(p for p in SIDE_LANE_BESIDE if p in args.phases.split(','))}")
    with open(text, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, cwd=ROOT)
    lane = dict(proc=proc, tmp=tmp, out=out, text=text, side=side, t0=time.perf_counter())
    _OPEN_LANES.append(lane)
    return lane


def finish_side_lane(lane, report, main_counts, timeout):
    """Wait for the side lane, replay its log and take its phases'
    reports and launches as if they had run here."""
    import shutil

    proc = lane["proc"]
    try:
        rc = proc.wait(timeout=max(1.0, timeout))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    if lane in _OPEN_LANES:
        _OPEN_LANES.remove(lane)
    with open(lane["text"]) as f:
        lines = f.read().splitlines()
    # Its last three lines are the card, its (empty) kernels line and its
    # own result line: this process prints those.
    body = lines[:-3] if rc == 0 else lines
    for line in body:
        log(f"  [side] {line}")
    if rc != 0:
        raise AssertionError(f"side lane {','.join(lane['side'])}: exit code {rc}")
    with open(lane["out"]) as f:
        side_report = json.load(f)
    shutil.rmtree(lane["tmp"], ignore_errors=True)
    for ph in lane["side"]:
        report["phases"][ph] = side_report["phases"][ph]
        # Each is a main path of its own: its launches add.
        for k, n in report["phases"][ph].get("launches", {}).items():
            if n:
                main_counts[k] = main_counts.get(k, 0) + n
    log(f"  side lane done {time.perf_counter() - lane['t0']:.1f} s after its start")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serial", action="store_true",
                    help="run every phase in this process, one after another (no side lane)")
    ap.add_argument("--budget-s", type=float, default=RUN_BUDGET_S,
                    help="fail, stopping every process of the run, once it is this many "
                         "seconds old (0: no budget)")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--out", default=None, help="also write the full report here (JSON)")
    ap.add_argument("--profile-serving", action="store_true",
                    help="also run the serving phases' profiled windows")
    ap.add_argument("--fleet-worker-restarts", type=int, default=FLEET["restarts"],
                    help="worker_restarts of the fleet phase (0 plants its gate (b) failure)")
    ap.add_argument("--w8a16-sweep", action="store_true",
                    help="with the parity phase, also time one decode step's W8A16 matmuls "
                         "over ring stages, chunks a stage and CTAs an SM (W8A16_SWEEP)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        log("CUDA is not available: this script runs the port on an NVIDIA GPU")
        return 2
    from areal_tpu_torch import kernels, resolve_device
    from areal_tpu_torch.models.hf.qwen2 import r1_distill_qwen_1_5b_config

    become_subreaper()
    guard_run(args.budget_s)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    rng = np.random.default_rng(args.seed)
    report = {"card": card, "phases": {}}
    kernel_rows = {}
    t_start = time.perf_counter()

    def phase_done(name, t0):
        report["phases"].setdefault(name, {})["phase_seconds"] = time.perf_counter() - t0
        log(f"  phase {name} took {time.perf_counter() - t0:.1f} s")

    log("phase build")
    secs = kernels.build_all()
    for name, text in kernels.build_logs.items():
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                log(f"  [{name}] entry {kernel_entry_name(entry.group(1))}")
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")
    log(f"  built {len(kernels.SOURCES)} kernel libraries in {secs:.1f} s")
    report["phases"]["build"] = {"seconds": secs}

    if "parity" in phases:
        log("phase parity")
        t0 = time.perf_counter()
        # The training-shape forward case and the timed chunk cases draw
        # from their own generator, so the draws of `rng`, and the later
        # phases' batches, stay those of a run without them.
        case_rng = np.random.default_rng([args.seed, 2])
        parity_flash(torch, rng, dev, kernel_rows, case_rng)
        parity_paged(torch, rng, dev, kernel_rows, int8=False, case_rng=case_rng)
        parity_paged(torch, rng, dev, kernel_rows, int8=True, case_rng=case_rng)
        parity_flash_bwd(torch, rng, dev, kernel_rows,
                         np.random.default_rng([args.seed, 1]))
        parity_gae(torch, rng, dev, kernel_rows, np.random.default_rng([args.seed, 3]))
        parity_w8a16(torch, dev, kernel_rows, np.random.default_rng([args.seed, 14]))
        if args.w8a16_sweep:
            report["w8a16_sweep"] = sweep_w8a16(torch, dev, np.random.default_rng([args.seed, 16]))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        phase_done("parity", t0)

    cfg = r1_distill_qwen_1_5b_config()
    serve_cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS)
    serving = [p for p in phases if p in ("serve_bf16", "serve_int8", "interrupt", "spec")]
    main_counts = {}
    if serving:
        from areal_tpu_torch.models.transformer import count_params, init_params

        t0 = time.perf_counter()
        params = init_params(serve_cfg, seed=args.seed, device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"serving model: R1-Distill-Qwen-1.5B widths, {SERVE_LAYERS} layers, "
            f"{count_params(params) / 1e9:.3f} B "
            f"params (bf16, seeded random) in {time.perf_counter() - t0:.1f} s")
        for ph, kvd, need in (("serve_bf16", None, ("flash_attn_fwd_bf16", "paged_decode_bf16")),
                              ("serve_int8", "int8", ("flash_attn_fwd_bf16", "paged_decode_int8"))):
            if ph not in phases:
                continue
            log(f"phase {ph}")
            t0 = time.perf_counter()
            report["phases"][ph] = serve_phase(torch, rng, dev, serve_cfg, params, kvd,
                                               profiled=args.profile_serving)
            counts = report["phases"][ph]["launches"]
            for k in need:
                if counts[k] <= 0:
                    raise AssertionError(f"{ph}: kernel {k} was not launched")
                main_counts.setdefault(k, counts[k])
            torch.cuda.empty_cache()
            phase_done(ph, t0)
        if "interrupt" in phases:
            log("phase interrupt")
            t0 = time.perf_counter()
            report["phases"]["interrupt"] = interrupt_phase(torch, rng, dev, serve_cfg, params)
            phase_done("interrupt", t0)
        if "spec" in phases:
            log("phase spec")
            t0 = time.perf_counter()
            # Its own generator: the later phases' draws stay those of a
            # run without it.
            report["phases"]["spec"] = spec_phase(
                torch, np.random.default_rng([args.seed, 15]), dev, serve_cfg, params,
                args.seed, card)
            # Speculative decoding and int8 weights are a main path of their
            # own: their launches add.
            for k, n in report["phases"]["spec"]["launches"].items():
                if n:
                    main_counts[k] = main_counts.get(k, 0) + n
            torch.cuda.empty_cache()
            phase_done("spec", t0)
        # The serving engines and pools are gone; free their weights too
        # before the server and the training phases.
        del params
        torch.cuda.empty_cache()

    if "http" in phases:
        log("phase http")
        t0 = time.perf_counter()
        # Its own generator: the later phases' batches stay those of a
        # run without it.
        report["phases"]["http"] = http_phase(torch, np.random.default_rng([args.seed, 4]),
                                              dev, serve_cfg, args.seed, card)
        counts = report["phases"]["http"]["launches"]
        for k in ("flash_attn_fwd_bf16", "paged_decode_bf16"):
            main_counts.setdefault(k, counts[k])
        torch.cuda.empty_cache()
        phase_done("http", t0)

    if "grad" in phases:
        log("phase grad")
        t0 = time.perf_counter()
        report["phases"]["grad"] = grad_phase(torch, rng, dev, cfg, args.seed)
        torch.cuda.empty_cache()
        phase_done("grad", t0)

    if "train" in phases:
        log("phase train")
        t0 = time.perf_counter()
        report["phases"]["train"] = train_phase(
            torch, rng, dev, dataclasses.replace(cfg, n_layers=TRAIN_LAYERS), args.seed)
        counts = report["phases"]["train"]["launches"]
        for k in ("flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16", "gae_scan_f32",
                  "packed_gae_f32"):
            main_counts[k] = counts[k]
        main_counts.setdefault("flash_attn_fwd_bf16", counts["flash_attn_fwd_bf16"])
        torch.cuda.empty_cache()
        phase_done("train", t0)

    side = ([p for p in SIDE_LANE if p in phases]
            if not args.serial and any(p in phases for p in SIDE_LANE_BESIDE) else [])
    lane = start_side_lane(args, side) if side else None

    if "workers" in phases:
        log("phase workers")
        t0 = time.perf_counter()
        # Cut in depth: the sft phase runs the same engine through the
        # worker system at SFT_LAYERS, the async_ppo phase the same dump
        # and server load.
        report["phases"]["workers"] = workers_phase(
            torch, np.random.default_rng([args.seed, 5]), dev,
            dataclasses.replace(cfg, n_layers=WORKERS_LAYERS), args.seed, card)
        # The worker system is a main path of its own: its launches add.
        for k, n in report["phases"]["workers"]["launches"].items():
            if n:
                main_counts[k] = main_counts.get(k, 0) + n
        torch.cuda.empty_cache()
        phase_done("workers", t0)

    if "async_ppo" in phases:
        log("phase async_ppo")
        t0 = time.perf_counter()
        # Cut in depth: the plane_loop phase runs the same loop, over
        # the plane, at PLANE_LOOP_LAYERS.
        report["phases"]["async_ppo"] = async_ppo_phase(
            torch, np.random.default_rng([args.seed, 7]), dev,
            dataclasses.replace(cfg, n_layers=ASYNC_LAYERS), args.seed, card)
        # The async loop is a main path of its own: its launches add.
        for k, n in report["phases"]["async_ppo"]["launches"].items():
            if n:
                main_counts[k] = main_counts.get(k, 0) + n
        torch.cuda.empty_cache()
        phase_done("async_ppo", t0)

    if "sync_ppo" in phases:
        log("phase sync_ppo")
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        report["phases"]["sync_ppo"] = sync_ppo_phase(
            torch, np.random.default_rng([args.seed, 12]), dev,
            dataclasses.replace(cfg, n_layers=SYNC_LAYERS), args.seed, card)
        # Sync PPO is a main path of its own: its launches add.
        for k, n in report["phases"]["sync_ppo"]["launches"].items():
            if n:
                main_counts[k] = main_counts.get(k, 0) + n
        torch.cuda.empty_cache()
        phase_done("sync_ppo", t0)

    if "sft" in phases:
        log("phase sft")
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        report["phases"]["sft"] = sft_phase(torch, np.random.default_rng([args.seed, 10]), dev,
                                            dataclasses.replace(cfg, n_layers=SFT_LAYERS),
                                            args.seed, card)
        # SFT is a main path of its own: its launches add.
        for k, n in report["phases"]["sft"]["launches"].items():
            if n:
                main_counts[k] = main_counts.get(k, 0) + n
        torch.cuda.empty_cache()
        phase_done("sft", t0)

    if lane is not None:
        finish_side_lane(lane, report, main_counts,
                         timeout=args.budget_s - (time.monotonic() - T_START)
                         if args.budget_s > 0 else 3600.0)
        if "plane_loop" in lane["side"]:
            log_plane_loop(report, card)

    if "disagg" in phases:
        log("phase disagg")
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        # Cut in depth (DISAGG_LAYERS): the run's time limit.
        report["phases"]["disagg"] = disagg_phase(
            torch, np.random.default_rng([args.seed, 8]), dev,
            dataclasses.replace(cfg, n_layers=DISAGG_LAYERS), args.seed, card)
        # Disaggregated serving is a main path of its own: its launches add.
        for k, n in report["phases"]["disagg"]["launches"].items():
            if n:
                main_counts[k] = main_counts.get(k, 0) + n
        torch.cuda.empty_cache()
        phase_done("disagg", t0)

    if "weight_plane" in phases:
        log("phase weight_plane")
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        wp = report["phases"]["weight_plane"] = weight_plane_phase(
            torch, np.random.default_rng([args.seed, 9]), dev,
            dataclasses.replace(cfg, n_layers=PLANE_FLEET_LAYERS), args.seed, card)
        # The plane is a main path of its own: its launches add.
        for k, n in wp["launches"].items():
            if n:
                main_counts[k] = main_counts.get(k, 0) + n
        torch.cuda.empty_cache()
        phase_done("weight_plane", t0)

    if "plane_loop" in phases and "plane_loop" not in side:
        log("phase plane_loop")
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        report["phases"]["plane_loop"] = plane_loop_phase(
            torch, np.random.default_rng([args.seed, 18]), dev,
            dataclasses.replace(cfg, n_layers=PLANE_LOOP_LAYERS), args.seed, card)
        # The loop over the plane is a main path of its own: its launches add.
        for k, n in report["phases"]["plane_loop"]["launches"].items():
            if n:
                main_counts[k] = main_counts.get(k, 0) + n
        torch.cuda.empty_cache()
        phase_done("plane_loop", t0)
        log_plane_loop(report, card)

    if "recover" in phases and "recover" not in side:
        log("phase recover")
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        report["phases"]["recover"] = recover_phase(
            torch, np.random.default_rng([args.seed, 11]), dev,
            dataclasses.replace(cfg, n_layers=RECOVER_LAYERS), args.seed, card)
        # Recovery is a main path of its own: its launches add.
        for k, n in report["phases"]["recover"]["launches"].items():
            if n:
                main_counts[k] = main_counts.get(k, 0) + n
        torch.cuda.empty_cache()
        phase_done("recover", t0)

    if "agentic" in phases and "agentic" not in side:
        log("phase agentic")
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        report["phases"]["agentic"] = async_ppo_phase(
            torch, np.random.default_rng([args.seed, 13]), dev,
            dataclasses.replace(cfg, n_layers=AGENTIC_LAYERS), args.seed, card,
            sizes=AGENTIC_SIZES, agentic=True)
        # Agentic RL is a main path of its own: its launches add.
        for k, n in report["phases"]["agentic"]["launches"].items():
            if n:
                main_counts[k] = main_counts.get(k, 0) + n
        torch.cuda.empty_cache()
        phase_done("agentic", t0)

    if "fleet" in phases:
        log("phase fleet")
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        report["phases"]["fleet"] = async_ppo_phase(
            torch, np.random.default_rng([args.seed, 17]), dev,
            dataclasses.replace(cfg, n_layers=FLEET_LAYERS), args.seed, card,
            sizes=FLEET_SIZES, plane=FLEET_PLANE,
            fleet=dict(FLEET, restarts=args.fleet_worker_restarts))
        # The fleet under failures is a main path of its own: its launches add.
        for k, n in report["phases"]["fleet"]["launches"].items():
            if n:
                main_counts[k] = main_counts.get(k, 0) + n
        torch.cuda.empty_cache()
        phase_done("fleet", t0)

    kernels_line = []
    for name, row in kernel_rows.items():
        row = dict(row)
        # null where no phase that runs this kernel on its main path ran
        row["launches"] = main_counts.get(name)
        if name == "gae_scan_f32":
            row["note"] = ("the scan entry (segment_scan_reverse); the PPO path runs the same "
                           "kernel body through packed_gae_f32, so its count there is 0")
        row["kernel_ms"] = row["ms"]  # the same time under its other name
        row["card"] = card
        kernels_line.append(row)
    report["kernels"] = kernels_line
    report["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    gone = stop_descendants()
    if gone:
        log(f"  stopped {len(gone)} process(es) still running after the last phase: {gone}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        # A failed phase may leave workers behind: stop them all.
        leftover = stop_descendants()
        if leftover:
            print(f"stopped {len(leftover)} process(es) of the run: {leftover}",
                  file=sys.stderr, flush=True)
        for lane in _OPEN_LANES:
            with open(lane["text"]) as f:
                for line in f.read().splitlines():
                    print(f"  [side, stopped] {line}", file=sys.stderr, flush=True)
    sys.exit(code)
