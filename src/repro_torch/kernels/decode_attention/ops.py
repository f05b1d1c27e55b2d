"""Public wrapper of the GQA flash-decode kernel.

Counterpart of ``repro.kernels.decode_attention.ops.decode_attention``, with
its layout (q (B, H, dh), caches (B, Hkv, S, dh), out (B, H, dh) float32)
plus the reference oracle's per-sequence ``lengths``. Inputs are checked;
then

* a CPU tensor takes the plain version (:mod:`.ref`);
* a CUDA tensor launches the hand-written kernel
  (``csrc/decode_attention.cu``) on the current stream, or raises. There is
  no fallback: a build failure, a refused launch or an unsupported input is
  an error.

The caches may be float32 or bfloat16 and any strided view whose last
dimension is contiguous: the model zoo passes its (B, S, Hkv, dh) cache as
``cache.transpose(1, 2)``, which the kernel reads in place. On the card the
head width must be a multiple of 16 bytes (8 bf16 or 4 f32 values) and at
most 256, the strides multiples of 16 bytes, and G = H / Hkv at most 16.
``lengths`` (B,) counts each sequence's valid keys, at least 1; ``None``
means all S. ``key_pos`` (B, S) and ``q_pos`` (B,), given together, mask
each slot by its stored position as the reference's decode does: slot l is
valid when ``key_pos[b, l] > 0`` and ``key_pos[b, l] - 1 <= q_pos[b]``
(positions stored +1, 0 for an empty slot). ``window`` (an int >= 1, with
``key_pos`` only) adds the sliding window's term ``q_pos[b] - (key_pos[b,
l] - 1) < window``: a ring buffer's slots hold positions in no order, which
the per-slot mask already takes. A key must pass every mask given, and each
sequence must keep at least one key.

The kernel cuts each sequence's cache into key ranges, one block of 1-4
warps each, and deals a range's 16-key tiles to its warps in turn
(:class:`Plan`, from :func:`launch_plan`, cached per shape, SM count,
registers and whether lengths are given);
with more than one range a second, small kernel merges them. ``LAUNCHES``
counts calls that launched the kernel, whether or not the call also ran
the merge.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, _costs
from repro_torch.kernels.decode_attention import ref

# The kernel's geometry (csrc names in brackets). The plan below is computed
# without the library, so these are kept here too; loading the library
# checks them against the kernel's own (``decode_attention_geometry``).
KT = 16  # keys a warp's tile (KT)
MAX_WARPS = 4  # warps a block (MAX_WARPS)
STAGES = 3  # copy ring depth a warp (STAGES): ~135 KB requested ahead on an SM at dh = 128 in bf16
MAX_GROUP = 16  # query heads per kv head (MAX_G)
BLOCK_GROUP = 8  # query heads a block holds: a larger group takes several blocks (BLOCK_G)
MAX_HEAD_DIM = 256  # (MAX_DH)
MAX_SMEM = 232_448  # dynamic shared memory a block may opt in to on an H100
MAX_BATCH = 65535  # the grid puts B on gridDim.z; the C entry caps Hkv at it too
# What an H100 SM holds at once: 228 KB of shared memory (a block also
# reserves 1 KB), 2048 threads, 65536 registers handed out to warps in units
# of 256, and at most 32 blocks.
SM_SMEM = 233_472
SM_THREADS = 2048
SM_REGS, REG_UNIT = 65_536, 256
SM_BLOCKS = 32
# A long cache is cut into ranges so that the launch takes the fewest
# tile-times: waves of blocks (blocks_per_sm resident on each SM) times the
# tiles a warp walks plus RANGE_COST_TILES (the pipeline's fill and the
# block's merge). With per-sequence lengths, blocks that end early are
# replaced by waiting ones only if there are any: at least MIN_WAVES waves
# where the cache allows. No range is shorter than MIN_RANGE_KEYS keys, nor
# so short that its parked sums, written and read back by the merge, pass
# PARK_SHARE of the cache bytes it reads.
MIN_WAVES = 4
RANGE_COST_TILES = 2
MIN_RANGE_KEYS = 512
PARK_SHARE = 1 / 16
LAUNCHES = 0

_fns: dict = {}
_sms: dict = {}
_regs: dict = {}  # (elem, padded group) -> registers a thread, read when the library loads


class Plan(NamedTuple):
    """How a launch cuts the cache: ``splits`` key ranges of ``range_keys``
    keys (the last may be shorter), one block of ``warps`` warps each per
    (sequence, kv head, head block); warp w of a block walks the range's
    16-key tiles w, w + warps, ... through its ring of STAGES stages.
    ``smem`` is a block's dynamic shared memory; ``sms`` the SM count it was
    made for."""

    splits: int
    range_keys: int
    warps: int
    blocks: int
    smem: int
    sms: int

    def ranges(self, s: int) -> List[Tuple[int, int]]:
        """The key ranges [start, end) of an S-slot cache, as the kernel cuts them."""
        step = self.range_keys
        return [(i * step, min(s, (i + 1) * step)) for i in range(self.splits)]

    def warp_tiles(self, lo: int, hi: int, warp: int) -> List[Tuple[int, int]]:
        """The tiles [k0, k1) warp ``warp`` walks in a range whose keys
        [lo, hi) lie below the sequence's length."""
        tiles = -(-(hi - lo) // KT)
        return [(lo + t * KT, min(hi, lo + (t + 1) * KT)) for t in range(warp, tiles, self.warps)]


def row_pitch(dh: int, elem: int) -> int:
    """Bytes of a staged K or V row (csrc: row_pitch): an odd number of 16-byte chunks."""
    return ((dh * elem // 16) | 1) * 16


def padded_group(g: int) -> int:
    """Query heads a block holds for a group of G (csrc: padded_group): G up
    to 4, else 8; the padding heads have zero q and are not written."""
    return g if g <= 4 else BLOCK_GROUP


def head_blocks(g: int) -> int:
    """Blocks a group of G heads takes on each key range (csrc: head_blocks)."""
    return -(-g // BLOCK_GROUP)


def smem_bytes(dh: int, elem: int, g: int, warps: int) -> int:
    """Dynamic shared memory of a block (csrc: smem_bytes): q of the padded
    group, then each warp's ring of K tile, V tile and the tile's positions."""
    stage = 2 * KT * row_pitch(dh, elem) + KT * 4
    return padded_group(g) * dh * 4 + warps * STAGES * stage


def blocks_per_sm(smem: int, warps: int, regs: int) -> int:
    """Blocks of ``warps`` warps, ``smem`` bytes and ``regs`` registers a
    thread that an H100 SM holds at once."""
    warp_regs = -(-regs * 32 // REG_UNIT) * REG_UNIT
    by_regs = (SM_REGS // warp_regs) // warps
    by_smem = SM_SMEM // (smem + 1024)
    return max(1, min(SM_BLOCKS, SM_THREADS // (32 * warps), by_smem, by_regs))


def parked_bytes(b: int, h: int, dh: int, splits: int) -> int:
    """Bytes the ranges park and the merge reads back: (acc, m, l) of every
    head and range, written once and read once; none with one range."""
    return 0 if splits == 1 else 2 * 4 * b * h * splits * (dh + 2)


def split_plan(b: int, hkv: int, g: int, s: int, dh: int, elem: int, sms: int, want: int) -> Plan:
    """At least ``want`` key ranges (fewer if S has too few tiles), each a
    whole number of tiles and none empty; as many warps a block, up to
    MAX_WARPS, as a range has tiles and shared memory holds."""
    tiles = -(-s // KT)
    per = max(1, tiles // max(1, want))
    splits = -(-tiles // per)
    warps = max(1, min(MAX_WARPS, per))
    while warps > 1 and smem_bytes(dh, elem, g, warps) > MAX_SMEM:
        warps -= 1
    smem = smem_bytes(dh, elem, g, warps)
    return Plan(splits, per * KT, warps, b * hkv * head_blocks(g) * splits, smem, sms)


@functools.lru_cache(maxsize=None)
def launch_plan(
    b: int, hkv: int, g: int, s: int, dh: int, elem: int, sms: int, regs: int, ragged: bool
) -> Plan:
    """The wrapper's plan for a shape on a card with ``sms`` SMs, whose
    kernel instantiation takes ``regs`` registers a thread: one range where
    S is short (the zoo's decode step: no merge kernel); else, among the
    plans with ranges of at least MIN_RANGE_KEYS keys whose parked sums stay
    within PARK_SHARE of the cache bytes (and, when the call passes
    per-sequence lengths, ``ragged``, with MIN_WAVES waves of blocks where
    one of them has), the one whose launch takes the fewest tile-times,
    fewer ranges on a tie."""
    cache = 2 * b * hkv * s * dh * elem
    by_splits = {1: split_plan(b, hkv, g, s, dh, elem, sms, 1)}
    for want in range(2, s // MIN_RANGE_KEYS + 1):
        plan = split_plan(b, hkv, g, s, dh, elem, sms, want)
        # of the wants that give one range count, the last cuts it most evenly
        if plan.range_keys >= MIN_RANGE_KEYS and plan.splits > 1:
            if parked_bytes(b, hkv * g, dh, plan.splits) <= PARK_SHARE * cache:
                by_splits[plan.splits] = plan
    plans = list(by_splits.values())

    def waves(plan: Plan) -> int:
        return -(-plan.blocks // (sms * blocks_per_sm(plan.smem, plan.warps, regs)))

    if ragged:
        most = max(waves(p) for p in plans)
        plans = [p for p in plans if waves(p) >= min(MIN_WAVES, most)]
    tiles = -(-s // KT)

    def cost(plan: Plan) -> tuple:
        per_warp = -(-min(tiles, plan.range_keys // KT) // plan.warps)
        return waves(plan) * (per_warp + RANGE_COST_TILES), plan.splits

    return min(plans, key=cost)


# the C entry's arguments: q, k, v, lengths, kpos, qpos, out, part_acc,
# part_ml; B, H, Hkv, S, dh; six cache strides; splits, range_keys, warps;
# window (0: none); scale; stream
ARGTYPES = (
    [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 5
    + [ctypes.c_longlong] * 6
    + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p]
)

# (dh, elem, G, warps) at which the load checks smem_bytes against the kernel's
_GEOMETRY_CASES = [
    (dh, elem, g, w)
    for dh, elem in ((8, 2), (80, 2), (128, 2), (136, 2), (256, 2), (4, 4), (80, 4), (256, 4))
    for g in (1, 3, 5, 16)
    for w in (1, 4)
]


def _check_geometry(lib) -> None:
    """Raise unless this module's copy of the kernel's geometry is the
    kernel's own."""
    query = lib.decode_attention_geometry
    query.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    query.restype = None
    out = (ctypes.c_longlong * 6)()
    for case in _GEOMETRY_CASES:
        query(*case, out)
        ours = (KT, MAX_WARPS, STAGES, MAX_GROUP, MAX_HEAD_DIM, smem_bytes(*case))
        if tuple(out) != ours:
            raise RuntimeError(
                f"decode_attention geometry at (dh, elem, G, warps) = {case}: the kernel has "
                f"{tuple(out)}, ops.py {ours} (KT, MAX_WARPS, STAGES, MAX_G, MAX_DH, shared bytes)"
            )


def _read_registers(lib) -> dict:
    """Each instantiation's registers a thread, keyed by (elem, padded group)."""
    query = lib.decode_attention_registers
    query.argtypes = [ctypes.c_int, ctypes.c_int]
    query.restype = ctypes.c_int
    regs = {}
    for elem in (2, 4):
        for g in (1, 2, 3, 4, BLOCK_GROUP):
            n = query(elem, g)
            if n <= 0:
                raise RuntimeError(
                    f"decode_attention registers at (elem, G) = {(elem, g)}: cudaError_t {-n}"
                )
            regs[elem, g] = n
    return regs


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library("decode_attention")
        _check_geometry(lib)
        _regs.update(_read_registers(lib))
        _lib = lib
    return _lib


def _kernel(dtype: torch.dtype):
    name = "decode_attention_bf16" if dtype == torch.bfloat16 else "decode_attention_f32"
    if name not in _fns:
        fn = getattr(_library(), name)
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def device_plan(q: torch.Tensor, k_cache: torch.Tensor, lengths=None) -> Plan:
    """:func:`launch_plan` for these inputs on their card (the SM count is
    read once per device, the registers once when the library loads)."""
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    if dev not in _sms:  # a property query per call costs more than the launch
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    b, h, dh = q.shape
    hkv, s, elem = k_cache.shape[1], k_cache.shape[2], k_cache.element_size()
    _library()
    regs = _regs[elem, padded_group(h // hkv)]
    return launch_plan(b, hkv, h // hkv, s, dh, elem, _sms[dev], regs, lengths is not None)


def _check(q, k_cache, v_cache, lengths, key_pos, q_pos, window=None) -> None:
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(
            f"need q (B, H, dh) and caches (B, Hkv, S, dh), got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)}"
        )
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"v_cache {tuple(v_cache.shape)} != k_cache {tuple(k_cache.shape)}")
    b, h, dh = q.shape
    kb, hkv, s, kdh = k_cache.shape
    if kb != b or kdh != dh or hkv < 1 or h % hkv != 0 or s < 1:
        raise ValueError(
            f"q {tuple(q.shape)} does not fit caches {tuple(k_cache.shape)}: need equal B and "
            "dh, S >= 1, and H a multiple of Hkv"
        )
    if lengths is not None:
        if not torch.is_tensor(lengths) or lengths.shape != (b,):
            raise ValueError(f"lengths must be a ({b},) tensor")
        if lengths.is_floating_point() or lengths.device != q.device:
            raise ValueError(f"lengths must be integer and on {q.device}")
    if (key_pos is None) != (q_pos is None):
        raise ValueError("key_pos and q_pos come together: give both or neither")
    if key_pos is not None:
        for name, t, shape in (("key_pos", key_pos, (b, s)), ("q_pos", q_pos, (b,))):
            if not torch.is_tensor(t) or t.shape != shape:
                raise ValueError(f"{name} must be a {shape} tensor")
            if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
                raise ValueError(f"{name} must be integer, got {t.dtype}")
            if t.device != q.device:
                raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if window is not None:
        if key_pos is None:
            raise ValueError("a window masks by stored positions: give key_pos and q_pos with it")
        if isinstance(window, bool) or not isinstance(window, int) or window < 1:
            raise ValueError(f"window must be an int >= 1, got {window!r}")


def _check_card(q, k_cache, v_cache) -> None:
    """What the CUDA route takes besides :func:`_check`'s contract."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k_cache, v_cache)):
        raise NotImplementedError(
            "the decode-attention kernel has no backward (decode runs without grad)"
        )
    b, h, dh = q.shape
    hkv = k_cache.shape[1]
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"the kernel takes float32 or bfloat16 caches of one dtype, got {k_cache.dtype} "
            f"and {v_cache.dtype}"
        )
    step = 16 // k_cache.element_size()
    if h // hkv > MAX_GROUP or dh > MAX_HEAD_DIM or dh % step:
        raise ValueError(
            f"the kernel takes G = H / Hkv <= {MAX_GROUP} and a head width that is a multiple "
            f"of {step} up to {MAX_HEAD_DIM}; got G = {h // hkv}, dh = {dh}"
        )
    if b > MAX_BATCH or hkv > MAX_BATCH:
        raise ValueError(f"the kernel takes B and Hkv up to {MAX_BATCH}, got {b} and {hkv}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(3) != 1 or any(st % step for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must have a contiguous last dimension, 16-byte aligned rows and "
                f"strides that are multiples of 16 bytes; got strides {t.stride()}"
            )


def launch(
    q, k_cache, v_cache, lengths, key_pos, q_pos, plan: Plan, window: Optional[int] = None
) -> torch.Tensor:
    """Launch the kernel on checked CUDA inputs with a given plan (the
    wrapper passes :func:`device_plan`'s; a benchmark may pass another)."""
    global LAUNCHES
    b, h, dh = q.shape
    _, hkv, s, _ = k_cache.shape
    qf = q.float().contiguous()
    if lengths is not None:
        lengths = lengths.to(torch.int32).contiguous()
    if key_pos is not None:
        key_pos = key_pos.to(torch.int32).contiguous()
        q_pos = q_pos.to(torch.int32).contiguous()
    out = torch.empty((b, h, dh), device=q.device, dtype=torch.float32)
    part_acc = part_ml = None
    if plan.splits > 1:
        part_acc = torch.empty((b * h * plan.splits * dh,), device=q.device, dtype=torch.float32)
        part_ml = torch.empty((b * h * plan.splits * 2,), device=q.device, dtype=torch.float32)
    ptrs = (qf, k_cache, v_cache, lengths, key_pos, q_pos, out, part_acc, part_ml)
    err = _build.call(
        _kernel(k_cache.dtype),
        q.device,
        *(None if t is None else t.data_ptr() for t in ptrs),
        b,
        h,
        hkv,
        s,
        dh,
        *k_cache.stride()[:3],
        *v_cache.stride()[:3],
        plan.splits,
        plan.range_keys,
        plan.warps,
        0 if window is None else window,
        math.log2(math.e) / math.sqrt(dh),  # scores in log2 units: the kernel takes exp2
    )
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError_t {err}")
    LAUNCHES += 1
    if _costs.COUNTERS:  # q·K and P·V over every slot; both caches, q and out once, the masks
        masks = sum(4 * t.numel() for t in (lengths, key_pos, q_pos) if t is not None)
        nbytes = 2 * b * s * hkv * dh * k_cache.element_size() + 2 * b * h * dh * 4 + masks
        _costs.report("decode_attention", 4 * b * h * s * dh, nbytes)
    return out


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    key_pos: Optional[torch.Tensor] = None,
    q_pos: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One query token per sequence against its KV cache.

    q (B, H, dh), caches (B, Hkv, S, dh), lengths (B,) int or None, key_pos
    (B, S) and q_pos (B,) int or both None, window an int >= 1 or None →
    (B, H, dh) float32; head h attends with kv head h // (H / Hkv)."""
    _check(q, k_cache, v_cache, lengths, key_pos, q_pos, window)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths, key_pos, q_pos, window)
    if q.device.type != "cuda":
        raise ValueError(f"no decode-attention route for device {q.device}")
    _check_card(q, k_cache, v_cache)
    plan = device_plan(q, k_cache, lengths)
    return launch(q, k_cache, v_cache, lengths, key_pos, q_pos, plan, window)
