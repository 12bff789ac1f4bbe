"""Per-channel int8 weights for the serving DECODE path, W8A16
(counterpart of ``areal_tpu/ops/wquant.py``).

Decode at small batch streams every weight once a step. An int8 copy of
the decode-path matmul weights halves that stream; activations, norms,
biases, the embedding lookup and every PREFILL path stay in the model's
dtype (prefill runs the unquantized params, so prompt processing is
identical to the unquantized engine). Opt-in through
``ServingEngine(decode_weight_dtype="int8")``.

Convention: ``w ~= w_q * scale`` with ``scale = absmax(w, input dim) /
127`` per output channel (symmetric int8, no round(127.5) wrap), so the
dequantization commutes with the matmul: ``h @ (w_q * s) == (h @ w_q) *
s``, and ``qmat`` scales the OUTPUT.

On the TPU the reference leaves the int8-to-bf16 convert to XLA, which
folds it into the matmul's operand read. PyTorch has no such fusion, so
on the card the decode tree holds each int8 weight packed for the
hand-written W8A16 kernel (``csrc/w8a16_matmul.cu``; ``PackedW8``, made
by ``maybe_quantize_decode_weights`` for CUDA params only), the
projections that read the same input (``wq|wk|wv``, ``w_gate|w_up``)
packed side by side so that one launch computes them, and ``qmat`` /
``qmats`` launch the kernel. A CPU tree keeps the reference's ``(int8
[in, out], scale)`` pairs, and ``qmat`` runs the plain version
``(h @ w_q.to(cdt)) * s.to(cdt)`` on it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from areal_tpu_torch import kernels

_Q = 127.0  # symmetric int8 range used for weights (no round(127.5) wrap)
_INV_Q = float(torch.tensor(1.0 / _Q, dtype=torch.float32))  # 1/127 rounded to float32

# Decode-path matmul weight names (attention projections + dense MLP).
_QUANT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in", "w_out"}
)

# Projections that read the same input, packed side by side on the card:
# (subtree, names); the packed leaf is stored under "+".join(names).
GROUPS = (("attn", ("wq", "wk", "wv")), ("mlp", ("w_gate", "w_up")))

# The kernel's tiles (csrc/w8a16_matmul.cu): output channels a column tile
# (wgmma's 64 rows), K depth of a packed chunk, bytes of a chunk.
TN, CK = 64, 64
CHUNK = TN * CK
# Row-block widths (wgmma's N) the kernel is built for; more rows than the
# widest run in several row blocks.
MB_WIDTHS = (16, 32, 48, 64, 80, 96, 128, 160, 192, 256)
# Shared memory of an SM, and the most one CTA may take, on the H100; the
# system keeps SMEM_RESERVED of an SM's share for each resident CTA.
SMEM_SM, SMEM_CTA, SMEM_RESERVED = 233472, 232448, 1024
# The ring's default shape: stages of CPS chunks, and CTAs an SM.
STAGES, CPS, CTAS_PER_SM = 4, 2, 1


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., in, out] float -> (int8 [..., in, out], float32 scale [...,
    out]). The reference's serving engine runs its quantize under jit,
    where XLA turns the division by 127 into a product with the float32
    reciprocal; the scale here is that product, and ``torch.round`` rounds
    half to even as ``jnp.round`` does, so codes and scales equal the tree
    the reference serves, bit for bit, from the same float32 input."""
    w32 = w.float()
    s = torch.clamp(w32.abs().amax(dim=-2), min=1e-8) * _INV_Q
    q = torch.clamp(torch.round(w32 / s[..., None, :]), -_Q, _Q).to(torch.int8)
    return q.contiguous(), s


def _qmat_plain(h: torch.Tensor, wq: torch.Tensor, s: torch.Tensor, cdt) -> torch.Tensor:
    """The plain version: dequantize to the compute dtype, matmul, scale."""
    return (h @ wq.to(cdt)) * s.to(cdt)


# ----------------------------------------------------------------------
# The packed layout
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _chunk_order() -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) of one packed chunk: byte p of a packed chunk is element
    src[p] = n * CK + k of the chunk's [TN, CK] (channel, depth) tile, and
    dst is the inverse permutation. Byte p = (j * 128 + thread) * 16 + b is
    the b-th byte of the j-th 16-byte load of consumer `thread` (warp w =
    thread // 32, g = lane // 4, t = lane % 4): its k16 step kk = 2 j + b //
    8 and, with r = b % 8, channel 16 w + g + 8 ((r // 2) % 2) and depth 16
    kk + 2 t + r % 2 + 8 (r // 4): wgmma's A fragment (a0 a1 a2 a3 of
    mma.sync m16n8k16 for each warp's 16 rows), two codes a register."""
    p = torch.arange(CHUNK)
    j, rem = p // 2048, p % 2048
    thread, b = rem // 16, rem % 16
    w, lane = thread // 32, thread % 32
    g, t = lane // 4, lane % 4
    kk, r = 2 * j + b // 8, b % 8
    n = 16 * w + g + 8 * ((r // 2) % 2)
    k = 16 * kk + 2 * t + r % 2 + 8 * (r // 4)
    src = n * CK + k
    dst = torch.empty_like(src)
    dst[src] = p
    return src, dst


def pack_codes(q: torch.Tensor) -> torch.Tensor:
    """int8 codes [..., K, N] -> [..., T, C, CHUNK] int8, T = ceil(N / 64)
    column tiles of C = ceil(K / 64) chunks, zero-padded; chunk (t, c) holds
    channels 64 t.. and depths 64 c.. in the kernel's fragment order
    (``_chunk_order``). Exact: ``unpack_codes`` inverts it."""
    *lead, K, N = q.shape
    T, C = -(-N // TN), -(-K // CK)
    padded = q.new_zeros((*lead, C * CK, T * TN))
    padded[..., :K, :N] = q
    tiles = padded.reshape(*lead, C, CK, T, TN).movedim(-2, -4)  # [..., T, C, CK, TN]
    tiles = tiles.transpose(-1, -2).reshape(*lead, T, C, CHUNK)  # n * CK + k
    src, _ = _chunk_order()
    return tiles.index_select(-1, src.to(q.device)).contiguous()


def unpack_codes(packed: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """The inverse of ``pack_codes``: [..., T, C, CHUNK] -> [..., K, N]."""
    *lead, T, C, _ = packed.shape
    _, dst = _chunk_order()
    tiles = packed.index_select(-1, dst.to(packed.device)).reshape(*lead, T, C, TN, CK)
    full = tiles.transpose(-1, -2).movedim(-4, -2).reshape(*lead, C * CK, T * TN)
    return full[..., :K, :N].contiguous()


@dataclasses.dataclass(frozen=True)
class PackedW8:
    """int8 weights packed for the W8A16 kernel: one [K, N] matrix, or the
    columns of several that read the same input side by side (``parts``,
    their widths). ``codes`` [..., T, C, CHUNK] (``pack_codes``), ``scale``
    [..., N] float32; leading dims are the stacked layers, and ``pw[i]`` is
    layer i's view. The tensors are checked once, where a PackedW8 is built
    from them; the kernel's wrapper, which runs per layer in a host-bound
    decode step, checks only what changes from call to call."""

    codes: torch.Tensor
    scale: torch.Tensor
    K: int
    parts: Tuple[int, ...]

    def __post_init__(self):
        c, s = self.codes, self.scale
        lead, T, C = tuple(c.shape[:-3]), -(-self.N // TN), -(-self.K // CK)
        if (c.dtype != torch.int8 or tuple(c.shape[-3:]) != (T, C, CHUNK)
                or s.dtype != torch.float32 or tuple(s.shape) != lead + (self.N,)):
            raise ValueError(
                f"PackedW8: codes {c.dtype} {tuple(c.shape)}, scales {s.dtype} "
                f"{tuple(s.shape)}: expected int8 [..., {T}, {C}, {CHUNK}] and float32 "
                f"[..., {self.N}] for K={self.K}, parts {self.parts}")
        if s.device != c.device:
            raise ValueError(f"PackedW8: codes on {c.device}, scales on {s.device}")
        # Every layer's view is bulk-copied chunk by chunk from 16-byte
        # aligned addresses.
        if not (c.is_contiguous() and s.is_contiguous()) or c.data_ptr() % 16:
            raise ValueError("PackedW8: codes and scales must be contiguous, the codes "
                             "16-byte aligned")

    @functools.cached_property
    def N(self) -> int:
        return sum(self.parts)

    def __getitem__(self, i) -> "PackedW8":
        # A layer's view of checked tensors (still contiguous and aligned to
        # whole chunks), built without checking them again.
        view = object.__new__(PackedW8)
        for name, value in (("codes", self.codes[i]), ("scale", self.scale[i]),
                            ("K", self.K), ("parts", self.parts)):
            object.__setattr__(view, name, value)
        return view


def pack_weights(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> PackedW8:
    """(int8 [..., K, N_i], scale [..., N_i]) pairs that share K -> one
    PackedW8 holding them side by side."""
    K = pairs[0][0].shape[-2]
    if any(q.shape[-2] != K for q, _ in pairs):
        raise ValueError("pack_weights: the projections do not share their input dim")
    q = torch.cat([q for q, _ in pairs], dim=-1) if len(pairs) > 1 else pairs[0][0]
    s = torch.cat([s for _, s in pairs], dim=-1) if len(pairs) > 1 else pairs[0][1]
    return PackedW8(pack_codes(q), s.contiguous(), K, tuple(q_.shape[-1] for q_, _ in pairs))


def unpack_weights(pw: PackedW8) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The inverse of ``pack_weights``: the (int8, scale) pair of each part."""
    q = unpack_codes(pw.codes, pw.K, pw.N)
    out, n0 = [], 0
    for n in pw.parts:
        out.append((q[..., n0:n0 + n].contiguous(), pw.scale[..., n0:n0 + n].contiguous()))
        n0 += n
    return out


# ----------------------------------------------------------------------
# The launch plan
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class W8Plan:
    """A launch of the W8A16 kernel: `mb` rows a row block (wgmma's N) and
    `n_rb` row blocks, `splits` K splits of whole chunks, `groups` sets of
    column tiles (every groups-th) a (row block, split), so n_rb * splits *
    groups CTAs; a ring of `stages` stages of `cps` chunks; `smem` bytes a
    CTA."""

    mb: int
    n_rb: int
    splits: int
    groups: int
    stages: int
    cps: int
    smem: int

    @property
    def ctas(self) -> int:
        return self.n_rb * self.splits * self.groups


def _epilogue_warps(mb: int) -> int:
    """The kernel's epilogue warps (csrc/w8a16_matmul.cu Epi), one tile
    buffer each."""
    return 4 if mb <= 64 else 3 if mb <= 96 else 2


def w8a16_smem(mb: int, cmax: int, stages: int, cps: int) -> int:
    """A CTA's shared memory (csrc/w8a16_matmul.cu smem_bytes): the ring,
    the A slice of `cmax` chunks, the epilogue warps' float32 tile buffers,
    the barriers (the ring's, the tile buffers', one an A chunk), a flag."""
    epi = _epilogue_warps(mb)
    return (stages * cps * CHUNK + cmax * CK * mb * 2 + epi * TN * mb * 4
            + (2 * stages + 3 * epi + cmax) * 8 + 16)


def _plan_cost(T: int, C: int, mb: int, splits: int, groups: int) -> float:
    """A CTA's work in weight chunks (4 KB each): its tiles' chunks, the
    partials a split tile writes and reads back, and staging its A slice
    (from L2, counted at a third of a weight byte)."""
    tiles, chunks = -(-T // groups), -(-C // splits)
    partial = mb / 16 if splits > 1 else 0.0
    return tiles * (chunks + partial) + chunks * mb / 96


@functools.lru_cache(maxsize=4096)
def w8a16_plan(M: int, K: int, N: int, n_sm: int, stages: int = STAGES, cps: int = CPS,
               ctas_per_sm: int = CTAS_PER_SM) -> W8Plan:
    """The launch for an [M, K] x [K, N] product on a card of `n_sm` SMs:
    row blocks of at most 256 rows, the fewest K splits whose A slice fits
    the shared memory of `ctas_per_sm` CTAs an SM, and among those splits
    and up, with at most ctas_per_sm * n_sm CTAs, the one whose busiest CTA
    has the least work (``_plan_cost``; fewer splits on a tie). It reads
    the shapes and the card only, so the same shapes always reduce in the
    same order."""
    if min(M, K, N) < 1:
        raise ValueError(f"w8a16_plan: empty product M={M} K={K} N={N}")
    if stages < 2 or stages % 2:
        raise ValueError(f"w8a16_plan: {stages} stages; the ring needs an even number (each "
                         "slot feeds one of the two consumer warpgroups)")
    T, C = -(-N // TN), -(-K // CK)
    n_rb = -(-M // MB_WIDTHS[-1])
    mb = next(w for w in MB_WIDTHS if w * n_rb >= M)
    budget = min(SMEM_CTA, SMEM_SM // ctas_per_sm - SMEM_RESERVED)
    cap = (budget - w8a16_smem(mb, 0, stages, cps)) // (CK * mb * 2)
    if cap < 1:
        raise ValueError(f"w8a16_plan: {stages} stages of {cps} chunks leave no room for "
                         f"{mb} rows at {ctas_per_sm} CTAs an SM")
    target = max(1, ctas_per_sm * n_sm)
    best = None
    for splits in range(-(-C // cap), C + 1):
        if n_rb * splits > target and best is not None:
            break
        groups = max(1, min(T, target // (n_rb * splits)))
        cost = _plan_cost(T, C, mb, splits, groups)
        if best is None or cost < best[0]:
            best = (cost, splits, groups)
    _, splits, groups = best
    return W8Plan(mb, n_rb, splits, groups, stages, cps,
                  w8a16_smem(mb, -(-C // splits), stages, cps))


# ----------------------------------------------------------------------
# The kernel's wrapper
# ----------------------------------------------------------------------

# The split launches' float32 partials and zeroed tile counters, by
# (device, stream): the kernel leaves the counters zeroed again, and
# launches on one stream run in order, so one stream's launches can share
# both.
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


# Partials up to this many floats are kept for the stream's next launch.
_KEEP_PARTIALS = 1 << 24


def _split_scratch(device: torch.device, stream: int, n_part: int, n_cnt: int):
    key = (device.index or 0, stream)
    ws, cnt = _scratch.get(key, (None, None))
    if cnt is None or cnt.numel() < n_cnt:
        cnt = torch.zeros((max(n_cnt, 4096),), dtype=torch.int32, device=device)
    if n_part > _KEEP_PARTIALS:
        _scratch[key] = (ws, cnt)
        return torch.empty((n_part,), dtype=torch.float32, device=device), cnt
    if ws is None or ws.numel() < n_part:
        ws = torch.empty((max(n_part, 1 << 20),), dtype=torch.float32, device=device)
    _scratch[key] = (ws, cnt)
    return ws, cnt


def w8a16_matmul(h: torch.Tensor, pw: PackedW8, stages: Optional[int] = None,
                 cps: Optional[int] = None, ctas_per_sm: Optional[int] = None) -> torch.Tensor:
    """``(h @ w_q) * s`` on the card for a packed weight: h [..., K] bf16,
    returns bf16 [..., N] (the parts side by side). Launches
    ``w8a16_matmul_bf16`` once; the ring and CTAs an SM default to the
    module's STAGES, CPS and CTAS_PER_SM. The decode step is host bound,
    so a call checks what changes from call to call (PackedW8 checked its
    tensors where it was built). The kernel loads the activations by TMA,
    which wants 16-byte rows: where K is not a multiple of 8 they are
    zero-padded to one (the packed weight is zero past K), and where they
    are not 16-byte aligned they are copied."""
    if not isinstance(pw, PackedW8):
        raise ValueError("w8a16_matmul: expected a PackedW8 (pack_weights)")
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"w8a16_matmul: expected CUDA tensors, got {dev}")
    K, N = pw.K, pw.N
    if h.shape[-1] != K:
        raise ValueError(f"w8a16_matmul: h {tuple(h.shape)} does not chain with K={K}")
    if h.dtype != torch.bfloat16:
        raise ValueError(f"w8a16_matmul: activations must be bfloat16, got {h.dtype}")
    if pw.codes.device != dev:
        raise ValueError(f"w8a16_matmul: the weight lives on {pw.codes.device}, h on {dev}")
    lead = h.shape[:-1]
    a = h.reshape(-1, K).contiguous()
    if K % 8:
        a = torch.nn.functional.pad(a, (0, -K % 8))
    elif a.data_ptr() % 16:
        a = a.clone()
    M = a.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return out.reshape(*lead, N)
    plan = w8a16_plan(M, K, N, kernels.sm_count(dev.index or 0),
                      STAGES if stages is None else stages, CPS if cps is None else cps,
                      CTAS_PER_SM if ctas_per_sm is None else ctas_per_sm)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = cnt = None
    if plan.splits > 1:
        T = -(-N // TN)
        ws, cnt = _split_scratch(dev, stream, plan.n_rb * T * plan.splits * TN * plan.mb,
                                 plan.n_rb * T)
    vec_c = int(N % 2 == 0 and out.data_ptr() % 4 == 0)
    kernels.launch("w8a16_matmul_bf16", a, pw.codes, pw.scale, out, ws, cnt, M, a.shape[1],
                   N, plan.mb, plan.n_rb, plan.splits, plan.groups, plan.stages, plan.cps,
                   vec_c, stream=stream)
    return out.reshape(*lead, N)


def qmat(h: torch.Tensor, w, cdt) -> torch.Tensor:
    """``h @ w`` for a plain weight, or ``(h @ w_q) * scale`` for int8
    weights: the W8A16 kernel for a packed weight on the card (a bfloat16
    compute dtype), the plain version for CPU tensors (a packed weight's
    codes unpacked first)."""
    if isinstance(w, PackedW8):
        if h.device.type == "cpu":
            return _qmat_plain(h, unpack_codes(w.codes, w.K, w.N), w.scale, cdt)
        if cdt != torch.bfloat16:
            raise ValueError(f"the W8A16 kernel computes in bfloat16, not {cdt}")
        return w8a16_matmul(h if h.dtype == cdt else h.to(cdt), w)
    if isinstance(w, tuple):
        wq, s = w
        if h.device.type != "cpu" or wq.device.type != "cpu":
            raise ValueError("qmat: int8 weights on the card run packed "
                             "(maybe_quantize_decode_weights packs CUDA trees)")
        return _qmat_plain(h, wq, s, cdt)
    return h @ w.to(cdt)


def qmats(h: torch.Tensor, tree, names: Sequence[str], cdt) -> Tuple[torch.Tensor, ...]:
    """``qmat(h, tree[name], cdt)`` for each name: one kernel launch when
    the tree holds them packed together (under ``"+".join(names)``), the
    outputs then views of one [..., sum N] tensor."""
    grp = tree.get("+".join(names))
    if grp is not None:
        return torch.split(qmat(h, grp, cdt), grp.parts, dim=-1)
    return tuple(qmat(h, tree[n], cdt) for n in names)


# ----------------------------------------------------------------------
# The decode tree
# ----------------------------------------------------------------------


def quantize_decode_weights(params, tied_embeddings: bool, pack: bool = False):
    """The decode-path int8 param tree of a served param tree.

    Returns a NEW dict sharing every unquantized leaf with ``params``
    (embedding for the token lookup, norms, biases), with:
      - layers/attn wq|wk|wv|wo and dense-MLP weights -> (int8, scale)
      - "head_q": the quantized LM head ((embedding.T) for tied weights)
    Leaves keep their leading stacked-layer dim; scales reduce the input
    dim only, so per-layer slices stay aligned. With ``pack`` every such
    leaf is a PackedW8 instead, the GROUPS side by side under their joined
    names (``wq+wk+wv``, ``w_gate+w_up``), each packed as it is quantized,
    so no unpacked copy outlives its leaf. The reference keeps MoE expert
    weights unquantized; the port has no MoE yet (ROADMAP Queue A, item
    6.2) and refuses such a tree."""

    def leaf(vs):
        pairs = [quantize_weight(v) for v in vs]
        return pack_weights(pairs) if pack else pairs[0]

    def walk(tree, grouped=()):
        if not isinstance(tree, dict):
            return tree
        out, taken = {}, set()
        for names in grouped:
            if pack and all(n in tree and not isinstance(tree[n], dict) for n in names):
                out["+".join(names)] = leaf([tree[n] for n in names])
                taken.update(names)
        for k, v in tree.items():
            if k in taken:
                continue
            if k in _QUANT_KEYS and not isinstance(v, dict):
                out[k] = leaf([v])
            else:
                out[k] = walk(v, [n for sub, n in GROUPS if sub == k])
        return out

    q = dict(params)
    q["layers"] = {}
    for k, v in params["layers"].items():
        if k == "mlp" and "router" in v:
            raise NotImplementedError("MoE models are not ported yet")
        q["layers"][k] = walk(v, [n for sub, n in GROUPS if sub == k])
    head_w = (params["embedding"]["weight"].T if tied_embeddings
              else params["head"]["weight"])
    q["head_q"] = leaf([head_w])
    return q


def unpack_decode_tree(q):
    """A packed decode tree in the reference's layout again: every
    PackedW8 back to the (int8, scale) pair of each of its parts, bit for
    bit (``unpack_weights``)."""

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if isinstance(v, PackedW8):
                out.update(zip(k.split("+"), unpack_weights(v)))
            else:
                out[k] = walk(v)
        return out

    return walk(q)


def maybe_quantize_decode_weights(params, tied_embeddings: bool, dtype: Optional[str]):
    """The int8 decode tree for ``dtype="int8"``, None for None / "model";
    packed for the kernel when the params live on the card."""
    if dtype is None or dtype == "model":
        return None
    if dtype != "int8":
        raise ValueError(
            f"decode_weight_dtype={dtype!r}: expected None, 'model', or 'int8'")
    with torch.no_grad():
        return quantize_decode_weights(
            params, tied_embeddings=tied_embeddings,
            pack=params["embedding"]["weight"].device.type == "cuda")
