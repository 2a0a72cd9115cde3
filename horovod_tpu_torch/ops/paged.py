"""Paged attention kernel for serving, and token selection.

The port of ``horovod_tpu/ops/pallas_paged.py``. The Pallas kernel
``_paged_attn_kernel`` becomes a CUDA C++ kernel written for Hopper
(``csrc/paged_attention.cu``), built with nvcc at first use and bound
with ctypes. :func:`paged_attention_fused` keeps the reference's
signature and layout: q ``[B, T, H, D]``, pools ``[NB, BS, KV, D]``,
block tables ``[B, nblk]`` int32 (-1 unassigned), positions ``[B]``.
``T = 1`` is the decode step, ``T = bucket`` the prefill and
``T = spec_k + 1`` the speculative verify step. Any head dim from 1 to
512: one that is not a multiple of 8 reaches the kernel zero-padded to
the next (a copy of q and both pools), the scores keeping its scale.

The kernel has two designs, chosen from shapes alone: split-KV decode
(each row's keys cut into ranges of whole pages, one block per range,
then a second launch that merges the partials in fixed order) for
``T * G <= MAX_DECODE_ROWS``, and a tensor-core prefill otherwise. In
bf16 both take every head dim: 16 to 128 stored columns, 256 for 136 to
256 (Gemma's head dim), and above 256 the output's columns in two parts
over the grid. In fp32 they take head dims up to 128; above, one simple
design takes every T: CUDA-core partials over 16-row tiles and ranges of
whole pages (:func:`wide_plan`), merged by the same combine launch. Each
launch is counted by the design that ran (:func:`design_of`).
:func:`split_partials` / :func:`combine_partials` are the decode design's
arithmetic in plain PyTorch, for tests; :func:`check_against_plain` is
the one bar the kernel is held to on the card.

On a CUDA tensor the wrapper launches the kernel or raises; it never
falls back. Only a tensor that lies on the CPU goes to the plain
version, :func:`horovod_tpu_torch.serve.kv_cache.paged_attention`.

Selection is ``HOROVOD_SERVE_KERNEL`` (``auto | cuda | reference``),
resolved once at executor build by :func:`resolve_kernel`.

Token selection is the reference's, in plain PyTorch on the logits'
device (the reference runs it as jnp inside its jitted step, outside any
Pallas kernel): :func:`filtered_probs` (temperature and the top-p
nucleus), :func:`sample_with_probs` (one draw per row from the
threefry keys of ``ops/prng.py``) and :func:`speculative_accept` (the
rejection-sampling accept rule of the verify step).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import torch

from ..core.config import KERNEL_CHOICES, Config
from ..serve import kv_cache as kvc
from . import prng
from .attention import (BF16_ATOL, BF16_NORM, BF16_RTOL, FP32_ATOL,
                        HEAD_DIMS, MAX_HEAD_DIM, NARROW_MAX_D, pad_head_dim)
from .ce import _on
from .prng import (STREAM_ACCEPT, STREAM_DRAFT, STREAM_RESIDUAL,  # noqa: F401
                   STREAM_SAMPLE)

#: kernel name, its CUDA source and the TPU kernel it replaces
KERNEL_NAME = "paged_attention"
KERNEL_SOURCE = "horovod_tpu_torch/ops/csrc/paged_attention.cu"
KERNEL_REPLACES = "horovod_tpu/ops/pallas_paged.py:94"
#: the fp32 design for head dims above NARROW_MAX_D, as the kernels line
#: of ``chip_smoke.py`` names it
WIDE_NAME = "paged_attention_wide"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows T * G of one (batch row, kv head) that the decode design takes; in
#: bf16 above head dim NARROW_MAX_D, in tiles of 16 rows, up to
#: MAX_DECODE_ROWS_WIDE (Gemma-2B's verify step has 32)
MAX_DECODE_ROWS, MAX_DECODE_ROWS_WIDE = 16, 64
#: the decode design's split: blocks per SM it aims for, shortest range
#: (a whole 64-key tile above head dim NARROW_MAX_D, where a block's fixed
#: cost, its 16 x 256 partial, is four times larger)
BLOCKS_PER_SM, MIN_SPLIT_KEYS, MIN_SPLIT_KEYS_WIDE = 4, 32, 64
#: query rows of one block of the design for head dims above 128
WIDE_ROWS = 16


def resolve_kernel(explicit: Optional[str] = None, *,
                   device: torch.device, config: Optional[Config] = None
                   ) -> str:
    """Resolve the paged attention path ONCE (executor build time).

    ``explicit`` (a model config's ``decode_kernel``) wins; otherwise the
    ``HOROVOD_SERVE_KERNEL`` knob decides. ``auto`` is ``"cuda"`` on a
    CUDA device and ``"reference"`` on the CPU. ``"cuda"`` on a CPU
    device raises. Returns ``"cuda"`` or ``"reference"``."""
    choice = explicit
    if choice is None:
        choice = (config or Config.from_env()).serve_kernel
    if choice not in KERNEL_CHOICES:
        raise ValueError(
            f"serve kernel must be one of {KERNEL_CHOICES}; got {choice!r}")
    device = torch.device(device)
    if choice == "auto":
        return "cuda" if device.type == "cuda" else "reference"
    if choice == "cuda" and device.type != "cuda":
        raise ValueError(
            f"serve kernel 'cuda' needs a CUDA device; got {device}")
    return choice


def check_head_dim(D: int) -> None:
    """Raise ``ValueError`` naming ``D`` unless the CUDA kernel takes head
    dim ``D`` (any from 1 to 512)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"the CUDA paged attention kernel takes a head_dim "
                         f"from 1 to {MAX_HEAD_DIM['fwd']}; got head_dim "
                         f"{D}")


def design_of(dtype: torch.dtype, D: int, rows: int) -> str:
    """The kernel function a launch runs for ``dtype`` at (padded) head
    dim ``D`` with ``rows = T * G`` query rows a (batch row, kv head)."""
    if dtype == torch.float32 and D > NARROW_MAX_D:
        return "paged_wide_kernel"
    most = MAX_DECODE_ROWS if D <= NARROW_MAX_D else MAX_DECODE_ROWS_WIDE
    kind = "decode" if rows <= most else "prefill"
    return f"{kind}_{'bf16' if dtype == torch.bfloat16 else 'f32'}_kernel"


def _check(q, pool_k, pool_v, block_tables, positions):
    """Raise on inputs the kernel and its plain version do not take;
    returns their device and ``(B, T, H, D, BS, KV, nblk)``."""
    qs, ks = q.shape, pool_k.shape
    if len(qs) != 4 or len(ks) != 4:
        raise ValueError(
            f"q must be [B, T, H, D] and pools [NB, BS, KV, D]; got "
            f"{tuple(qs)} and {tuple(ks)}")
    if pool_v.shape != ks:
        raise ValueError(f"pool_k {tuple(ks)} and pool_v "
                         f"{tuple(pool_v.shape)} differ")
    B, _, H, D = qs
    KV = ks[2]
    if H % KV:
        raise ValueError(
            f"q heads {H} must be a multiple of kv heads {KV}")
    if ks[3] != D:
        raise ValueError(f"head dim {D} != pool head dim {ks[3]}")
    ts = block_tables.shape
    if len(ts) != 2 or ts[0] != B:
        raise ValueError(f"block_tables must be [{B}, nblk]; got "
                         f"{tuple(ts)}")
    if positions.shape != (B,):
        raise ValueError(f"positions must be [{B}]; got "
                         f"{tuple(positions.shape)}")
    dt = q.dtype
    if dt not in _DTYPES or pool_k.dtype != dt or pool_v.dtype != dt:
        raise ValueError(
            f"q and pools must share one dtype of float32/bfloat16; got "
            f"{dt}, {pool_k.dtype}, {pool_v.dtype}")
    dev = q.device
    if not (pool_k.device == dev and pool_v.device == dev
            and block_tables.device == dev and positions.device == dev):
        devs = {t.device for t in (q, pool_k, pool_v, block_tables,
                                   positions)}
        raise ValueError(f"all inputs must be on one device; got {devs}")
    return dev, (B, qs[1], H, D, ks[1], KV, ts[1])


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import _native
        lib = _native.load(KERNEL_NAME)
        # pointers as c_void_p: without argtypes ctypes would pass each
        # Python int as a 32-bit C int and cut the pointer
        lib.hvd_paged_attention_decode.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.hvd_paged_attention_prefill.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.hvd_paged_attention_wide.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        for fn in (lib.hvd_paged_attention_decode,
                   lib.hvd_paged_attention_prefill,
                   lib.hvd_paged_attention_wide):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _decode_plan(B: int, KV: int, nblk: int, BS: int, rows: int, D: int,
                 index: int) -> Tuple[int, int, int]:
    """``(n_split, keys_per_split, workspace floats)`` on device
    ``index``."""
    n_split, kps = decode_plan(B, KV, nblk, BS, rows, D, _sm_count(index))
    return n_split, kps, B * KV * n_split * rows * (D + 2)


def decode_plan(B: int, KV: int, nblk: int, BS: int, rows: int, D: int,
                sms: int = 132) -> Tuple[int, int]:
    """``(n_split, keys_per_split)`` of the decode design at (padded) head
    dim ``D``: :func:`split_plan`, above 128 over the ``B *
    ceil(rows / 16)`` row tiles and with ranges of at least
    ``MIN_SPLIT_KEYS_WIDE`` keys."""
    if D <= NARROW_MAX_D:
        return split_plan(B, KV, nblk, BS, sms)
    return split_plan(B * -(-rows // MAX_DECODE_ROWS), KV, nblk, BS, sms,
                      MIN_SPLIT_KEYS_WIDE)


@functools.lru_cache(maxsize=1024)
def _wide_plan(B: int, KV: int, nblk: int, BS: int, rows: int, D: int,
               index: int) -> Tuple[int, int, int]:
    n_split, kps = wide_plan(B, KV, nblk, BS, rows, _sm_count(index))
    return n_split, kps, B * KV * n_split * rows * (D + 2)


def wide_plan(B: int, KV: int, nblk: int, BS: int, rows: int,
              sms: int = 132) -> Tuple[int, int]:
    """``(n_split, keys_per_split)`` of the design for head dims above
    128: :func:`split_plan` over the ``B * ceil(rows / WIDE_ROWS)`` row
    tiles, so a decode step splits each row's keys as the decode design
    does and a prefill, which has many row tiles, takes few ranges."""
    return split_plan(B * -(-rows // WIDE_ROWS), KV, nblk, BS, sms)


def split_plan(B: int, KV: int, nblk: int, BS: int, sms: int = 132,
               min_keys: int = MIN_SPLIT_KEYS) -> Tuple[int, int]:
    """``(n_split, keys_per_split)`` of the decode design: each row's
    ``nblk`` pages cut into ranges of whole pages, enough of them that the
    ``(n_split, KV, B)`` grid puts about ``BLOCKS_PER_SM`` blocks on each
    of ``sms`` SMs, and no range shorter than ``min_keys`` keys. From
    shapes only: the positions never decide it (they stay on the
    device)."""
    want = -(-BLOCKS_PER_SM * sms // max(B * KV, 1))
    pages = min(max(-(-min_keys // BS), -(-nblk // want)), nblk)
    return -(-nblk // pages), pages * BS


def paged_attention_fused(q: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, block_tables: torch.Tensor,
                          positions: torch.Tensor) -> torch.Tensor:
    """Masked attention of each row's ``T * G`` queries over its paged
    KV, key ``j`` valid for position ``t`` iff ``j <= positions + t``.
    Output ``[B, T, H, D]`` in q's dtype.

    CUDA tensors launch the hand-written kernel (and count the call in
    ``paged_attention_fused.launches`` and its design's in
    ``.design_launches``): the split-KV decode design and its combine
    when ``T * G <= MAX_DECODE_ROWS`` (``MAX_DECODE_ROWS_WIDE`` in bf16
    above head dim 128), else the prefill design; in fp32 above head dim
    128 the wide design and its combine. CPU tensors run the plain
    version. Any other device raises."""
    dev, (B, T, H, D, BS, KV, nblk) = _check(q, pool_k, pool_v,
                                             block_tables, positions)
    if dev.type == "cpu":
        return kvc.paged_attention(q, pool_k, pool_v, block_tables,
                                   positions)
    if dev.type != "cuda":
        raise ValueError(f"paged attention runs on cuda or cpu; got {dev}")
    check_head_dim(D)
    if not (q.is_contiguous() and pool_k.is_contiguous()
            and pool_v.is_contiguous() and block_tables.is_contiguous()
            and positions.is_contiguous()):
        raise ValueError("q, pools, block_tables and positions must be "
                         "contiguous")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("block_tables and positions must be int32")
    # a head dim that is not a multiple of 8 reaches the kernel zero-padded
    # (a copy of q and both pools); the scores keep D's scale
    q, pool_k, pool_v = pad_head_dim(q, pool_k, pool_v)
    Dp = q.shape[-1]
    qp, kp, vp = q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("q and pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or T == 0 or nblk == 0:
        return out[..., :D].zero_()
    lib = _lib()
    rows = T * (H // KV)
    with _on(dev):
        # the raw handle: torch.cuda.current_stream() builds a Stream
        # object, a large share of this call's host time
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        design = design_of(q.dtype, Dp, rows)
        if design == "paged_wide_kernel":
            n_split, kps, n_ws = _wide_plan(B, KV, nblk, BS, rows, Dp,
                                            dev.index)
            ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
            err = lib.hvd_paged_attention_wide(
                qp, kp, vp, block_tables.data_ptr(), positions.data_ptr(),
                out.data_ptr(), ws.data_ptr(), B, T, H, KV, Dp, D, BS,
                nblk, n_split, kps, _DTYPES[q.dtype], stream)
        elif design.startswith("decode"):
            n_split, kps, n_ws = _decode_plan(B, KV, nblk, BS, rows, Dp,
                                              dev.index)
            ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
            err = lib.hvd_paged_attention_decode(
                qp, kp, vp, block_tables.data_ptr(), positions.data_ptr(),
                out.data_ptr(), ws.data_ptr(), B, T, H, KV, Dp, D, BS,
                nblk, n_split, kps, _DTYPES[q.dtype], stream)
        else:
            err = lib.hvd_paged_attention_prefill(
                qp, kp, vp, block_tables.data_ptr(), positions.data_ptr(),
                out.data_ptr(), B, T, H, KV, Dp, D, BS, nblk,
                _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"paged attention kernel launch failed: cudaError_t {err} "
            f"(B={B} T={T} H={H} KV={KV} D={D} BS={BS} nblk={nblk})")
    count_launches(1, {design: 1})
    return out[..., :D]


#: calls that launched the CUDA kernel since the last reset (plain int),
#: and by design (:func:`design_of`); changed through
#: :func:`count_launches` only
paged_attention_fused.launches = 0
paged_attention_fused.design_launches = {}

_count_lock = threading.Lock()
_capture_state = threading.local()


class _CaptureWindow:
    """The K1 wrapper calls one thread made inside one graph capture, in
    all and by design."""

    __slots__ = ("n", "designs")

    def __init__(self):
        self.n = 0
        self.designs = {}


def _add(counts: dict, designs) -> None:
    for k, v in (designs or {}).items():
        counts[k] = counts.get(k, 0) + v


def count_launches(n: int = 1, designs=None) -> None:
    """Count ``n`` K1 launches, ``designs`` their count by design: into
    the calling thread's open :func:`capture_window` if it has one
    (wrapper calls inside a graph capture launch nothing then; they are
    what each replay launches), else into ``paged_attention_fused``'s
    ``launches`` and ``design_launches``, under a lock, so executors that
    replay on several threads each add all of theirs."""
    win = getattr(_capture_state, "window", None)
    if win is not None:
        win.n += n
        _add(win.designs, designs)
        return
    with _count_lock:
        paged_attention_fused.launches += n
        _add(paged_attention_fused.design_launches, designs)


@contextlib.contextmanager
def capture_window():
    """Count the calling thread's K1 wrapper calls apart while a graph
    is being captured: yields an object whose ``n`` is their number.
    Other threads' launches (a sibling executor's replays) still go to
    ``paged_attention_fused.launches`` and never into the window; the
    window's calls never reach that total."""
    prev = getattr(_capture_state, "window", None)
    win = _CaptureWindow()
    _capture_state.window = win
    try:
        yield win
    finally:
        _capture_state.window = prev


# ---------------------------------------------------------------------------
# the decode design's arithmetic in plain PyTorch (tests only)
# ---------------------------------------------------------------------------

def _kernel_view(q, pool_k, pool_v, block_tables, positions):
    """The inputs as the kernel sees them, fp32: scores ``[B, KV, R, L]``
    (``R = T * G`` rows ``t * G + g``, divide-after-dot scale), ``-inf``
    where a key is invalid for the row (past ``pos + t`` or in an
    unassigned page), and values ``[B, KV, L, D]`` zeroed where the
    kernel reads nothing (past ``pos + T - 1`` or in an unassigned page:
    such bytes may be stale, NaN patterns included)."""
    B, T, H, D = q.shape
    BS, KV = pool_k.shape[1], pool_k.shape[2]
    nblk = block_tables.shape[1]
    G, L = H // KV, nblk * BS
    tbl = block_tables.long()
    j = torch.arange(L, device=q.device)
    pos = positions.long()[:, None]
    loaded = (tbl >= 0).repeat_interleave(BS, dim=1) & (j < pos + T)
    gather = tbl.clamp(min=0)
    keys, vals = (p[gather].reshape(B, L, KV, D).float().permute(0, 2, 1, 3)
                  .masked_fill(~loaded[:, None, :, None], 0.0)
                  for p in (pool_k, pool_v))
    qf = q.float().reshape(B, T, KV, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, KV, T * G, D)
    s = torch.matmul(qf, keys.transpose(-1, -2)) / math.sqrt(D)
    t_of = torch.arange(T * G, device=q.device) // G
    valid = loaded[:, None, :] & (j <= pos[:, :, None] + t_of[:, None])
    return s.masked_fill(~valid[:, None], -math.inf), vals


def _heads_last(x: torch.Tensor, T: int) -> torch.Tensor:
    """``[B, KV, T * G, D] -> [B, T, KV * G, D]``."""
    B, KV, R, D = x.shape
    return x.reshape(B, KV, T, R // T, D).permute(0, 2, 1, 3, 4).reshape(
        B, T, R // T * KV, D)


def split_partials(q, pool_k, pool_v, block_tables, positions,
                   keys_per_split: int):
    """What the decode design's blocks write: for each range ``s`` of
    ``keys_per_split`` keys, per (row, kv head, query row) the running max
    ``m``, the sum ``l`` of ``exp(score - m)`` and the unnormalised value
    sum ``o``, fp32: ``m``, ``l [B, KV, n_split, T * G]``, ``o [B, KV,
    n_split, T * G, D]``. A range with no valid key has ``m = -inf``,
    ``l = 0`` and ``o = 0``."""
    s, vals = _kernel_view(q, pool_k, pool_v, block_tables, positions)
    B, KV, R, L = s.shape
    n = -(-L // keys_per_split)
    pad = n * keys_per_split - L
    s = torch.nn.functional.pad(s, (0, pad), value=-math.inf)
    vals = torch.nn.functional.pad(vals, (0, 0, 0, pad))
    s = s.reshape(B, KV, R, n, keys_per_split).transpose(2, 3)
    m = s.amax(-1)
    p = torch.exp(s - m.masked_fill(m == -math.inf, 0.0)[..., None])
    o = torch.matmul(p, vals.reshape(B, KV, n, keys_per_split, -1))
    return m, p.sum(-1), o


def combine_partials(m, l, o, T: int, dtype) -> torch.Tensor:
    """The combine launch: each row's partials merged in range order
    (weights ``exp(m_s - max m)``), ``[B, T, H, D]`` in ``dtype``; a row
    with no valid key in any range gets zeros."""
    M = m.amax(2)
    M = M.masked_fill(M == -math.inf, 0.0)
    L = torch.zeros_like(M)
    O = torch.zeros_like(o[:, :, 0])
    for s in range(m.shape[2]):
        w = torch.exp(m[:, :, s] - M)
        L = L + l[:, :, s] * w
        O = O + o[:, :, s] * w[..., None]
    out = torch.where(L[..., None] > 0,
                      O / torch.where(L > 0, L, 1.0)[..., None], 0.0)
    return _heads_last(out, T).to(dtype)


def paged_attention_split(q, pool_k, pool_v, block_tables, positions,
                          keys_per_split: int) -> torch.Tensor:
    """The decode design's function in plain PyTorch: partials over
    ranges of ``keys_per_split`` keys, then their combine. Keys of
    unassigned pages are left out, as the kernel leaves them out."""
    return combine_partials(
        *split_partials(q, pool_k, pool_v, block_tables, positions,
                        keys_per_split), q.shape[1], q.dtype)


# ---------------------------------------------------------------------------
# holding the kernel to its plain version
# ---------------------------------------------------------------------------

def plain_term_sums(q, pool_k, pool_v, block_tables, positions
                    ) -> torch.Tensor:
    """``sum_j p_j |v_j|`` behind each output element, ``[B, T, H, D]``
    fp32. Both bf16 designs round p to bf16 (relative error <= 2^-8)
    before P.V on the tensor cores, so they can move an element by at
    most 2^-8 times its term sum; both outputs are rounded to bf16 once
    more."""
    s, vals = _kernel_view(q, pool_k, pool_v, block_tables, positions)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m.masked_fill(m == -math.inf, 0.0))
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l > 0, l, 1.0)
    return _heads_last(torch.matmul(p, vals.abs()), q.shape[1])


def plain_reference(q, pool_k, pool_v, block_tables, positions):
    """``(want, sums)``: the plain version (``kv_cache.paged_attention``)
    and, for bf16, :func:`plain_term_sums`. Where a row's keys reach an
    unassigned page, the plain version reads block 0 in its place and the
    kernel leaves the page out; those rows are held to the kernel's
    function, :func:`paged_attention_split` over one range (zeros for a
    row with no valid key)."""
    want = kvc.paged_attention(q, pool_k, pool_v, block_tables, positions)
    B, T = q.shape[:2]
    BS, nblk = pool_k.shape[1], block_tables.shape[1]
    free = block_tables < 0
    first_free = torch.where(free.any(1), free.int().argmax(1), nblk)
    last = (positions.long()[:, None]
            + torch.arange(T, device=q.device)).clamp(max=nblk * BS - 1)
    inside = torch.div(last, BS, rounding_mode="floor") < first_free[:, None]
    if not bool(inside.all()):
        masked = paged_attention_split(q, pool_k, pool_v, block_tables,
                                       positions, nblk * BS)
        want = torch.where(inside[:, :, None, None], want, masked)
    sums = (None if q.dtype == torch.float32 else
            plain_term_sums(q, pool_k, pool_v, block_tables, positions))
    return want, sums


def compare_with_plain(got, want, sums, dtype) -> dict:
    """``max_abs_err``, ``ratio`` (the largest error over its bar; <= 1
    passes), ``rel_norm`` and ``ok``. fp32: max |err| <= FP32_ATOL (the
    same fp32 math in another order). bf16: every element within
    ``BF16_RTOL * (|plain| + term sum) + BF16_ATOL`` (twice what bf16
    rounding of p and of both outputs can explain) and ``||err|| /
    ||plain|| <= BF16_NORM``; the kernel's output finite."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rel = float(err.norm() / w.norm().clamp_min(1e-30))
    if dtype == torch.float32:
        ratio = float(err.max()) / FP32_ATOL
        ok = ratio <= 1.0
    else:
        bound = BF16_RTOL * (w.abs() + sums.float()) + BF16_ATOL
        ratio = float((err / bound).max())
        ok = ratio <= 1.0 and rel <= BF16_NORM
    ok = ok and bool(torch.isfinite(g).all())
    return {"max_abs_err": float(err.max()), "ratio": ratio,
            "rel_norm": rel, "ok": ok}


def check_against_plain(q, pool_k, pool_v, block_tables, positions,
                        kernel=None) -> dict:
    """Run the kernel (or ``kernel``, a callable with its signature) and
    :func:`plain_reference` on the same inputs and
    :func:`compare_with_plain` them."""
    got = (kernel or paged_attention_fused)(q, pool_k, pool_v,
                                            block_tables, positions)
    if got.dtype != q.dtype:
        raise TypeError(f"kernel output {got.dtype} for inputs {q.dtype}")
    want, sums = plain_reference(q, pool_k, pool_v, block_tables, positions)
    return compare_with_plain(got, want, sums, q.dtype)


# ---------------------------------------------------------------------------
# token selection: greedy, sampled (temperature / top-p, per-request
# seeds) and the speculative accept rule; plain PyTorch, on the logits'
# device, as the reference runs them inside its jitted step
# ---------------------------------------------------------------------------

def one_hot(idx: torch.Tensor, V: int) -> torch.Tensor:
    """fp32 one-hot rows ``[..., V]`` of ``idx``, as a scatter:
    ``F.one_hot`` range-checks its input on the host on a CPU tensor."""
    return torch.zeros(*idx.shape, V, device=idx.device).scatter_(
        -1, idx.long()[..., None], 1.0)


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """The greedy branch of the reference's ``sample_with_probs``: the
    argmax token per row of ``logits [B, V]`` as int32 (ties go to the
    lowest token id, as in the reference)."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def _any_sampled(temperature, sampled: Optional[bool]) -> bool:
    """Whether any row samples: ``sampled`` when the caller knows (the
    executor decides from its host copy), else read from the tensor (a
    device sync on the card)."""
    return bool((temperature > 0).any()) if sampled is None else sampled


def filtered_probs(logits: torch.Tensor, temperature: torch.Tensor,
                   top_p: torch.Tensor) -> torch.Tensor:
    """The sampling distribution: ``softmax(logits / max(t, 1e-6))``
    restricted to the top-p nucleus and renormalised, fp32 ``[..., V]``
    over ``[...]``-shaped per-row parameters (the reference's
    ``filtered_probs``).

    The nucleus keeps every token whose PRECEDING cumulative mass, in
    the stable descending order (the lower token id first on ties), is
    below ``top_p``: at least one token survives and ``top_p = 1`` keeps
    the whole distribution. Rows with ``temperature <= 0`` are the
    one-hot argmax (greedy as a special case of sampling)."""
    lf = logits.float()
    V = lf.shape[-1]
    greedy_hot = one_hot(lf.argmax(-1), V)
    t = temperature.float().clamp_min(1e-6)[..., None]
    pr = torch.softmax(lf / t, dim=-1)
    order = torch.argsort(-pr, dim=-1, stable=True)
    sp = torch.gather(pr, -1, order)
    keep_sorted = (torch.cumsum(sp, dim=-1) - sp) < top_p.float()[..., None]
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    f = torch.where(keep, pr, 0.0)
    f = f / f.sum(dim=-1, keepdim=True)
    return torch.where((temperature <= 0)[..., None], greedy_hot, f)


def _categorical(keys: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """One draw per row from explicit probabilities (zeros are never
    drawn: ``log(0) = -inf``), int32."""
    return prng.categorical(keys, torch.log(probs)).to(torch.int32)


def sample_with_probs(logits: torch.Tensor, temperature: torch.Tensor,
                      top_p: torch.Tensor, seed: torch.Tensor,
                      ctr: torch.Tensor, *, stream: int = STREAM_SAMPLE,
                      sampled: Optional[bool] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token per row of ``logits [B, V]``: ``(tokens [B] int32, probs
    [B, V] fp32)``, ``probs`` the exact filtered distribution each token
    was drawn from (what a draft executor hands the verify step as q).
    Per-row ``temperature`` / ``top_p`` / ``seed`` (uint32 values) /
    ``ctr`` tensors ``[B]``; each row draws from the key ``row_keys(seed,
    stream, ctr)``.

    An all-greedy batch (``sampled`` False, or no positive temperature)
    takes the argmax with no sort, as the reference's ``lax.cond`` does;
    greedy rows of a mixed batch give the same argmax."""
    gre = sample_greedy(logits)
    if not _any_sampled(temperature, sampled):
        return gre, one_hot(gre, logits.shape[-1])
    pr = filtered_probs(logits, temperature, top_p)
    tok = _categorical(prng.row_keys(seed, stream, ctr), pr)
    return torch.where(temperature <= 0, gre, tok), pr


def speculative_accept(tokens: torch.Tensor, draft_probs: torch.Tensor,
                       logits: torch.Tensor, n_draft: torch.Tensor,
                       temperature: torch.Tensor, top_p: torch.Tensor,
                       seed: torch.Tensor, ctr: torch.Tensor, *,
                       sampled: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rejection-sampling accept rule of the verify step (the
    reference's ``speculative_accept``).

    ``tokens [B, k+1]``: column 0 each row's last emitted token, columns
    1.. its draft proposals; ``draft_probs [B, k, V]``: the filtered
    distribution each proposal was drawn from; ``logits [B, k+1, V]``:
    the target's verify logits (position i scores the token after
    ``tokens[:, i]``); ``n_draft [B]``: how many proposals each row
    really has. Returns ``(emitted [B, k+1] int32, n_accept [B] int32)``;
    row r emits ``emitted[r, :n_accept[r] + 1]``.

    Draft i is accepted iff ``u_i q_i(x_i) < p_i(x_i)`` (u from the
    ``STREAM_ACCEPT`` keys at counter ``ctr + i``); the first rejection
    emits a draw from ``norm(relu(p_i - q_i))`` (``STREAM_RESIDUAL``), and
    a row that accepted every real draft emits a draw from
    ``p_{n_draft}`` (``STREAM_SAMPLE``, the bonus token). At temperature
    0 both distributions are one-hot and the rule is the argmax accept
    and rollback; an all-greedy batch takes that branch with no sort."""
    B, K1, V = logits.shape
    k = K1 - 1
    dev = logits.device
    drafts = tokens[:, 1:].long()
    iot = torch.arange(k, device=dev)[None, :]
    has_draft = iot < n_draft.long()[:, None]
    preds = torch.argmax(logits.float(), dim=-1)               # [B, k+1]

    def n_accepted(acc):
        return torch.cumprod(acc.long(), dim=1).sum(dim=1)

    if not _any_sampled(temperature, sampled):
        n_acc = n_accepted((drafts == preds[:, :k]) & has_draft)
        fix = torch.gather(preds, 1, n_acc[:, None])[:, 0]
        return _assemble(drafts, fix, n_acc)
    p = filtered_probs(logits, temperature[:, None].expand(B, K1),
                       top_p[:, None].expand(B, K1))
    q = draft_probs.float()
    p_tok = torch.gather(p[:, :k], -1, drafts[..., None])[..., 0]
    q_tok = torch.gather(q, -1, drafts[..., None])[..., 0]
    ctr_i = (ctr.long()[:, None] + iot).reshape(-1)            # [B * k]
    seed_i = seed[:, None].expand(B, k).reshape(-1)
    u = prng.uniform(prng.row_keys(seed_i, STREAM_ACCEPT, ctr_i)).reshape(
        B, k)
    n_acc = n_accepted((u * q_tok < p_tok) & has_draft)
    # a residual draw per draft position, gathered at the first rejection;
    # rows with p == q never reach theirs (the fallback keeps it finite)
    res_un = torch.clamp_min(p[:, :k] - q, 0.0)
    res_sum = res_un.sum(dim=-1, keepdim=True)
    res = torch.where(res_sum > 0, res_un / res_sum.clamp_min(1e-20),
                      p[:, :k])
    res_tok = _categorical(prng.row_keys(seed_i, STREAM_RESIDUAL, ctr_i),
                           res.reshape(B * k, V)).reshape(B, k)
    # a full draw per verify position: the bonus token when every real
    # draft was accepted (position n_draft has no draft to reject)
    ctr_f = (ctr.long()[:, None]
             + torch.arange(K1, device=dev)[None, :]).reshape(-1)
    seed_f = seed[:, None].expand(B, K1).reshape(-1)
    full_tok = _categorical(prng.row_keys(seed_f, STREAM_SAMPLE, ctr_f),
                            p.reshape(B * K1, V)).reshape(B, K1)
    # greedy rows: every draw above collapses to the argmax
    g = (temperature <= 0)[:, None]
    res_tok = torch.where(g, preds[:, :k].int(), res_tok)
    full_tok = torch.where(g, preds.int(), full_tok)
    fix_pool = torch.cat(
        [torch.where(n_acc[:, None] < n_draft.long()[:, None], res_tok,
                     full_tok[:, :k]), full_tok[:, k:]], dim=1)
    fix = torch.gather(fix_pool, 1, n_acc[:, None])[:, 0]
    return _assemble(drafts, fix, n_acc)


def _assemble(drafts: torch.Tensor, fix: torch.Tensor, n_acc: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[accepted drafts..., fix token, zero padding]`` per row."""
    B, k = drafts.shape
    iot = torch.arange(k + 1, device=drafts.device)[None, :]
    drafts_pad = torch.cat([drafts, drafts.new_zeros(B, 1)], dim=1)
    na = n_acc[:, None]
    emitted = torch.where(
        iot < na, drafts_pad,
        torch.where(iot == na, fix.long()[:, None], 0))
    return emitted.to(torch.int32), n_acc.to(torch.int32)
