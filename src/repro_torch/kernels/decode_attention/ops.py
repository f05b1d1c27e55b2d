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
(positions stored +1, 0 for an empty slot). A key must pass every mask
given, and each sequence must keep at least one key. ``LAUNCHES`` counts
calls that launched the kernel (a call that splits a long cache across
blocks also runs the small merge kernel).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ref

MAX_GROUP = 16  # query heads per kv head
MAX_HEAD_DIM = 256
TILE = 64  # keys per tile in the kernel
LAUNCHES = 0

_fns: dict = {}
_sms: dict = {}


def _kernel(dtype: torch.dtype):
    name = "decode_attention_bf16" if dtype == torch.bfloat16 else "decode_attention_f32"
    if name not in _fns:
        fn = getattr(_build.load_library("decode_attention"), name)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
        fn.argtypes += [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def num_splits(batch: int, kv_heads: int, seq: int, sms: int) -> int:
    """Ranges of the cache axis, one block each: enough blocks for about two
    per SM, but no range shorter than 8 tiles (512 keys)."""
    tiles = -(-seq // TILE)
    want = -(-2 * sms // (batch * kv_heads))
    return max(1, min(want, tiles // 8))


def _check(q, k_cache, v_cache, lengths, key_pos, q_pos) -> None:
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


def _launch(q, k_cache, v_cache, lengths, key_pos, q_pos) -> torch.Tensor:
    global LAUNCHES
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k_cache, v_cache)):
        raise NotImplementedError(
            "the decode-attention kernel has no backward (decode runs without grad)"
        )
    b, h, dh = q.shape
    _, hkv, s, _ = k_cache.shape
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"the kernel takes float32 or bfloat16 caches of one dtype, got {k_cache.dtype} "
            f"and {v_cache.dtype}"
        )
    elem = k_cache.element_size()
    step = 16 // elem
    if h // hkv > MAX_GROUP or dh > MAX_HEAD_DIM or dh % step:
        raise ValueError(
            f"the kernel takes G = H / Hkv <= {MAX_GROUP} and a head width that is a multiple "
            f"of {step} up to {MAX_HEAD_DIM}; got G = {h // hkv}, dh = {dh}"
        )
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(3) != 1 or any(st % step for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must have a contiguous last dimension, 16-byte aligned rows and "
                f"strides that are multiples of 16 bytes; got strides {t.stride()}"
            )
    qf = q.float().contiguous()
    if lengths is not None:
        lengths = lengths.to(torch.int32).contiguous()
    if key_pos is not None:
        key_pos = key_pos.to(torch.int32).contiguous()
        q_pos = q_pos.to(torch.int32).contiguous()
    out = torch.empty((b, h, dh), device=q.device, dtype=torch.float32)
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    if dev not in _sms:  # a property query per call costs more than the launch
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = num_splits(b, hkv, s, _sms[dev])
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((b * h * splits * dh,), device=q.device, dtype=torch.float32)
        part_ml = torch.empty((b * h * splits * 2,), device=q.device, dtype=torch.float32)
    err = _build.call(
        _kernel(k_cache.dtype),
        q.device,
        qf.data_ptr(),
        k_cache.data_ptr(),
        v_cache.data_ptr(),
        None if lengths is None else lengths.data_ptr(),
        None if key_pos is None else key_pos.data_ptr(),
        None if q_pos is None else q_pos.data_ptr(),
        out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        b,
        h,
        hkv,
        s,
        dh,
        *k_cache.stride()[:3],
        *v_cache.stride()[:3],
        splits,
        1.0 / math.sqrt(dh),
    )
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    key_pos: Optional[torch.Tensor] = None,
    q_pos: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One query token per sequence against its KV cache.

    q (B, H, dh), caches (B, Hkv, S, dh), lengths (B,) int or None, key_pos
    (B, S) and q_pos (B,) int or both None → (B, H, dh) float32; head h
    attends with kv head h // (H / Hkv)."""
    _check(q, k_cache, v_cache, lengths, key_pos, q_pos)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths, key_pos, q_pos)
    if q.device.type != "cuda":
        raise ValueError(f"no decode-attention route for device {q.device}")
    return _launch(q, k_cache, v_cache, lengths, key_pos, q_pos)
