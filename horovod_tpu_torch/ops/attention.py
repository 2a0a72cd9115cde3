"""Flash attention: the forward (K4) and backward (K5 dQ, K6 dK/dV) kernels.

The port of ``horovod_tpu/ops/pallas_attention.py``. The Pallas kernels
``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` become CUDA
C++ written for Hopper (``csrc/flash_attention.cu``), built with nvcc at
first use and bound with ctypes. The public entries keep the reference's
layout and semantics: q ``[B, H, Sq, D]``, k / v ``[B, KV, Skv, D]`` with
H a multiple of KV (query head h reads kv head ``h // (H // KV)``; K/V
are never expanded), the default scale ``1 / sqrt(D)`` applied to q in
fp32, a top-left aligned causal mask (``q_pos >= k_pos``, also when
Sq != Skv), ragged lengths masked by their real bounds, and a row that
sees no key giving ``o = 0`` and ``lse = log(1e-20)``.

On a CUDA tensor the forward launches K4 (which also writes the per-row
``lse [B, H, Sq]`` fp32) and the backward computes
``delta = rowsum(do * o)`` in fp32 (minus the lse cotangent, for
:func:`flash_attention_lse`), then launches K5 and K6. K6 sums the GQA
group in fp32 and casts dk / dv to k's dtype once; in bf16 it runs in
pieces (:func:`dkv_split_plan`: a share of the group's heads and of the
query tiles each), whose fp32 partials a second launch sums in piece
order. Each wrapper call adds one to ``flash_attention.fwd_launches`` /
``.dq_launches`` / ``.dkv_launches`` (K6's combine included), and to the
count of the design it ran in ``flash_attention.design_launches``
(:func:`design_of`). There is no fallback: a launch that fails, a dtype
other than fp32 / bf16 or a head dim above a kernel's limit
(``MAX_HEAD_DIM``) raises. In bf16 the forward runs on the tensor cores
at every head dim: up to 128 on stored widths of 16 to 128 columns, from
136 to 256 on 256 (two warpgroups a block), and from 264 to 512 with its
output's columns split in two parts over the grid. Above 128 the
backward (both dtypes) and the fp32 forward run on one simple design per
kernel (CUDA cores, fp32 math; K6 in one launch, no pieces; the fp32
forward split as the bf16 one above 256); the backward stops at 256, and
a differentiable call on the card above 256 raises before its forward. A
head dim that is not a multiple of 8 is zero-padded to the next one by a
copy (:func:`pad_head_dim`), and the outputs are sliced back. On a CPU
tensor the same ``torch.autograd.Function`` runs the kernels' plain
versions (:func:`flash_fwd_plain`,
:func:`flash_bwd_dq_plain`, :func:`flash_bwd_dkv_plain`: dense fp32
math on the materialised ``[Sq, Skv]`` scores), so CPU tests exercise the
custom backward too. Any other device raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .ce import _on

#: kernel names, their CUDA source and the TPU kernels they replace
LIBRARY = "flash_attention"
KERNEL_SOURCE = "horovod_tpu_torch/ops/csrc/flash_attention.cu"
FWD_NAME = "flash_attention_fwd"
DQ_NAME = "flash_attention_bwd_dq"
DKV_NAME = "flash_attention_bwd_dkv"
FWD_REPLACES = "horovod_tpu/ops/pallas_attention.py:72"
DQ_REPLACES = "horovod_tpu/ops/pallas_attention.py:163"
DKV_REPLACES = "horovod_tpu/ops/pallas_attention.py:205"

#: K6 in bf16: the keys of a block and the queries of a tile it walks, and
#: the most such query tiles one block walks (:func:`dkv_split_plan`)
DKV_TILE, DKV_MAX_TILES = 64, 64

#: the reference's mask value (``pallas_attention.NEG_INF``)
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest head dim each kernel takes: the forward (K4, and K1's
#: serving) splits its output's columns in two parts above 256; the
#: backward (K5, K6) stops at 256. Every D up to its limit: up to
#: ``NARROW_MAX_D`` an instance stores 16, 32, 64 or 128 columns and
#: zero-fills those past D, above it 256 columns (a part); the copies move
#: 16 bytes, so a D that is not a multiple of 8 reaches the kernels
#: zero-padded to :func:`padded_dim` by a copy in the wrapper.
MAX_HEAD_DIM = {"fwd": 512, "dq": 256, "dkv": 256}
NARROW_MAX_D = 128
#: the head dims the forward (and K1) takes
HEAD_DIMS = tuple(range(1, MAX_HEAD_DIM["fwd"] + 1))
#: the CUDA-core designs for head dims above NARROW_MAX_D (bf16's forward
#: is on the tensor cores there), as the kernels line of ``chip_smoke.py``
#: names them
WIDE_NAMES = {"fwd": "flash_attention_fwd_wide",
              "dq": "flash_attention_bwd_dq_wide",
              "dkv": "flash_attention_bwd_dkv_wide"}


def padded_dim(D: int) -> int:
    """The width a head dim reaches the kernels at: D rounded up to a
    multiple of 8."""
    return -(-D // 8) * 8


def pad_head_dim(*ts: torch.Tensor):
    """``ts`` zero-padded along the last (head) dim to
    :func:`padded_dim` (new contiguous tensors), or ``ts`` themselves when
    D is a multiple of 8. Zero columns add nothing to a dot product, and
    the outputs' padded columns are sliced off."""
    D = ts[0].shape[-1]
    Dp = padded_dim(D)
    if Dp == D:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, Dp - D)) for t in ts)


# ---------------------------------------------------------------------------
# the dense reference (the port's copies of parallel/sp.py's helpers)
# ---------------------------------------------------------------------------

def expand_kv_heads(k: torch.Tensor, v: torch.Tensor, groups: int):
    """``[B, KV, S, D] -> [B, KV * groups, S, D]`` by head repetition:
    query head h uses kv head ``h // groups``."""
    if groups == 1:
        return k, v
    return (k.repeat_interleave(groups, dim=1),
            v.repeat_interleave(groups, dim=1))


def attention_reference(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention at full head width (k / v already expanded), fp32
    math, output in q's dtype: the reference path, differentiated by
    autograd."""
    D = q.shape[-1]
    scale_ = scale if scale is not None else 1.0 / (D ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale_
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[-2], s.shape[-1], s.device),
                          NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _causal_mask(Sq: int, Skv: int, device) -> torch.Tensor:
    """``[Sq, Skv]``: query i sees key j iff i >= j (top-left aligned)."""
    return (torch.arange(Sq, device=device)[:, None]
            >= torch.arange(Skv, device=device)[None, :])


# ---------------------------------------------------------------------------
# the plain versions of the three kernels
# ---------------------------------------------------------------------------

def _scores(q, k, causal, scale):
    """fp32 scores ``[B, H, Sq, Skv]`` of q (pre-scaled) against the kv
    heads expanded to H, and the validity mask."""
    G = q.shape[1] // k.shape[1]
    ke = k.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, ke)
    mask = (_causal_mask(q.shape[2], k.shape[2], q.device) if causal
            else torch.ones(q.shape[2], k.shape[2], dtype=torch.bool,
                            device=q.device))
    return s, mask


def flash_fwd_plain(q, k, v, causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version: ``(o in q's dtype, lse [B, H, Sq] fp32)``."""
    s, mask = _scores(q, k, causal, scale)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1)
    safe_m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - safe_m[..., None]).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1).clamp(min=1e-20)
    G = q.shape[1] // k.shape[1]
    o = torch.einsum("bhqk,bhkd->bhqd", p,
                     v.float().repeat_interleave(G, dim=1))
    o = o / l[..., None]
    return o.to(q.dtype), safe_m + torch.log(l)


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    s, mask = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None].float()).masked_fill(~mask, 0.0)
    G = q.shape[1] // k.shape[1]
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(),
                      v.float().repeat_interleave(G, dim=1))
    return p, p * (dp - delta[..., None].float())


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool,
                       scale: float) -> torch.Tensor:
    """K5's plain version: ``dq = scale * ds k`` in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    G = q.shape[1] // k.shape[1]
    dq = torch.einsum("bhqk,bhkd->bhqd", ds,
                      k.float().repeat_interleave(G, dim=1))
    return (dq * scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version: ``dk = ds^T (scale q)`` and ``dv = p^T do``
    per query head, summed over each kv head's group in fp32, in k's
    dtype."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    B, KV, Skv, D = k.shape
    G = q.shape[1] // KV
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float() * scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = dk.reshape(B, KV, G, Skv, D).sum(dim=2)
    dv = dv.reshape(B, KV, G, Skv, D).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def dkv_split_plan(G: int, Sq: int, max_tiles: Optional[int] = None
                   ) -> Tuple[int, int, int]:
    """K6's split in bf16, from shapes only: ``(heads_per_piece,
    tiles_per_chunk, n_chunks)``. A piece is ``heads_per_piece`` query
    heads of a group and one chunk of ``tiles_per_chunk`` query tiles of
    ``DKV_TILE`` rows; piece ``hg * n_chunks + c`` takes heads
    ``[hg hp, (hg + 1) hp)`` and chunk ``c``, so ``G // hp * n_chunks``
    pieces cover every (query head, query tile) pair once. The heaviest
    K6 block (the first key tile, which every query sees) walks
    ``heads_per_piece * tiles_per_chunk`` tiles, at most ``max_tiles``
    (``DKV_MAX_TILES``): as many heads a piece as fit, else one head and
    the query range cut into chunks."""
    max_tiles = max_tiles or DKV_MAX_TILES
    nqt = -(-Sq // DKV_TILE)
    if nqt >= max_tiles:
        return 1, max_tiles, -(-nqt // max_tiles)
    hp = max(d for d in range(1, G + 1) if G % d == 0 and d * nqt <= max_tiles)
    return hp, nqt, 1


def dkv_pieces(G: int, plan: Tuple[int, int, int]) -> int:
    hp, _, n_chunks = plan
    return G // hp * n_chunks


def dkv_scratch_bytes(B: int, KV: int, Skv: int, D: int, G: int,
                      plan: Tuple[int, int, int]) -> int:
    """Bytes of K6's fp32 partials (dk and dv of every piece); 0 with one
    piece, which writes dk / dv itself."""
    n = dkv_pieces(G, plan)
    return 0 if n == 1 else 2 * n * B * KV * Skv * D * 4


def dkv_split_partials(q, k, v, do, lse, delta, causal: bool, scale: float,
                       plan: Optional[Tuple[int, int, int]] = None):
    """What K6's pieces write (plain PyTorch, tests only): ``(dk, dv)``
    partials ``[pieces, B, KV, Skv, D]`` fp32, piece ``hg * n_chunks + c``
    summing its heads and its chunk's queries; dk without the scale. p and
    ds are rounded to q's dtype before the second product, as the bf16
    kernel rounds its operands."""
    B, KV, Skv, D = k.shape
    H, Sq = q.shape[1], q.shape[2]
    G = H // KV
    hp, chunk, n_chunks = plan or dkv_split_plan(G, Sq)
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    p, ds = (t.to(q.dtype).float().reshape(B, KV, G, Sq, Skv)
             for t in (p, ds))
    qf, dof = (t.float().reshape(B, KV, G, Sq, D) for t in (q, do))
    rows = chunk * DKV_TILE
    dks, dvs = [], []
    for hg in range(G // hp):
        heads = slice(hg * hp, (hg + 1) * hp)
        for c in range(n_chunks):
            sl = slice(c * rows, (c + 1) * rows)
            dks.append(torch.einsum("bgjqk,bgjqd->bgkd",
                                    ds[:, :, heads, sl], qf[:, :, heads, sl]))
            dvs.append(torch.einsum("bgjqk,bgjqd->bgkd",
                                    p[:, :, heads, sl], dof[:, :, heads, sl]))
    return torch.stack(dks), torch.stack(dvs)


def dkv_combine_partials(dk_parts, dv_parts, scale: float, dtype
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's combine launch: the partials summed in piece order in fp32, dk
    times the scale, each cast to ``dtype`` once."""
    dk = torch.zeros_like(dk_parts[0])
    dv = torch.zeros_like(dv_parts[0])
    for i in range(dk_parts.shape[0]):
        dk = dk + dk_parts[i]
        dv = dv + dv_parts[i]
    return (dk * scale).to(dtype), dv.to(dtype)


# ---------------------------------------------------------------------------
# holding the kernels to their plain versions
# ---------------------------------------------------------------------------

#: fp32 bars: max |err| on o and lse; on dq / dk / dv, times max|plain|
FP32_ATOL, FP32_GRAD_RTOL = 1e-4, 2e-4
#: bf16 bars, per element: |err| <= BF16_RTOL * (|plain| + term sum)
#: + BF16_ATOL, and over a tensor ||err|| / ||plain|| <= BF16_NORM
BF16_RTOL, BF16_ATOL, BF16_NORM = 2.0 ** -7, 1e-4, 1e-2


def plain_term_sums(q, k, v, do, lse, delta, causal: bool, scale: float
                    ) -> dict:
    """The sums of absolute terms behind each output element: ``|p| |v|``
    (o), ``|scale| |ds| |k|`` (dq), ``|scale| |ds|^T |q|`` and ``|p|^T |do|``
    summed over the GQA group (dk, dv). A bf16 kernel rounds p and ds to
    bf16 (relative error <= 2^-8) before the second product, so it can
    move an element by at most 2^-8 times its term sum; its output and
    the plain version's are each rounded to bf16 once more (2^-8 of the
    value each)."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    B, KV, Skv, D = k.shape
    G = q.shape[1] // KV
    ds, scale = ds.abs(), abs(scale)
    ke, ve = (t.float().abs().repeat_interleave(G, dim=1) for t in (k, v))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float().abs() * scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float().abs())
    return {"o": torch.einsum("bhqk,bhkd->bhqd", p, ve),
            "dq": torch.einsum("bhqk,bhkd->bhqd", ds, ke) * scale,
            "dk": dk.reshape(B, KV, G, Skv, D).sum(dim=2),
            "dv": dv.reshape(B, KV, G, Skv, D).sum(dim=2)}


def compare_with_plain(got: dict, want: dict, sums: dict, dtype,
                       names=("o", "lse", "dq", "dk", "dv")) -> dict:
    """Per output of ``names`` (``o``, ``lse``, ``dq``, ``dk``, ``dv``):
    ``max_abs_err``, ``ratio`` (the largest error over its bar; <= 1
    passes), ``rel_norm`` and ``ok``. fp32, and lse in every dtype: max
    |err| <= FP32_ATOL on o and lse and <= FP32_GRAD_RTOL x max|plain| on
    the gradients (the same fp32 math in another order). bf16: every element within
    ``BF16_RTOL * (|plain| + term sum) + BF16_ATOL`` (twice what bf16
    rounding of p / ds and of both outputs can explain; the atol covers
    fp32 noise where ds cancels, e.g. a row that sees one key) and
    ``||err|| / ||plain|| <= BF16_NORM``."""
    out = {}
    for name in names:
        g, w = got[name].float(), want[name].float()
        err = (g - w).abs()
        rel = float(err.norm() / w.norm().clamp_min(1e-30))
        if dtype == torch.float32 or name == "lse":
            bar = (FP32_GRAD_RTOL * float(w.abs().max())
                   if name.startswith("d") else FP32_ATOL)
            ratio = float(err.max()) / bar
            ok = ratio <= 1.0
        else:
            bound = BF16_RTOL * (w.abs() + sums[name].float()) + BF16_ATOL
            ratio = float((err / bound).max())
            ok = ratio <= 1.0 and rel <= BF16_NORM
        ok = ok and bool(torch.isfinite(g).all())
        out[name] = {"max_abs_err": float(err.max()), "ratio": ratio,
                     "rel_norm": rel, "ok": ok}
    return out


def check_against_plain(q, k, v, do, dlse, causal: bool, scale: float,
                        kernels=None) -> dict:
    """Run K4, K5 and K6 (or ``kernels``, three callables with their
    signatures) and their plain versions on the same inputs (the plain
    backward fed the kernel's lse and a delta with a live lse cotangent,
    ``delta = rowsum(do o) - dlse``) and :func:`compare_with_plain` the
    outputs."""
    fwd, dq_fn, dkv_fn = kernels or (flash_fwd_kernel, flash_bwd_dq_kernel,
                                     flash_bwd_dkv_kernel)
    o, lse = fwd(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1) - dlse
    dq = dq_fn(q, k, v, do, lse, delta, causal, scale)
    dk, dv = dkv_fn(q, k, v, do, lse, delta, causal, scale)
    if o.dtype != q.dtype or dq.dtype != q.dtype or dk.dtype != k.dtype:
        raise TypeError(f"kernel outputs {o.dtype}, {dq.dtype}, {dk.dtype} "
                        f"for inputs {q.dtype}")
    o_p, lse_p = flash_fwd_plain(q, k, v, causal, scale)
    dq_p = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    dk_p, dv_p = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    sums = ({} if q.dtype == torch.float32 else
            plain_term_sums(q, k, v, do, lse, delta, causal, scale))
    return compare_with_plain(
        {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv},
        {"o": o_p, "lse": lse_p, "dq": dq_p, "dk": dk_p, "dv": dv_p},
        sums, q.dtype)


def check_forward_against_plain(q, k, v, causal: bool, scale: float,
                                kernel=None) -> dict:
    """K4 alone (or ``kernel``, a callable with its signature) against its
    plain version on the same inputs: :func:`compare_with_plain` on o and
    lse, o's term sums ``|p| |v|`` as for the whole check. The check of
    head dims the backward kernels do not take (above 256)."""
    o, lse = (kernel or flash_fwd_kernel)(q, k, v, causal, scale)
    if o.dtype != q.dtype:
        raise TypeError(f"kernel output {o.dtype} for inputs {q.dtype}")
    o_p, lse_p = flash_fwd_plain(q, k, v, causal, scale)
    sums = {}
    if q.dtype != torch.float32:
        s, mask = _scores(q, k, causal, scale)
        p = torch.exp(s - lse_p[..., None]).masked_fill(~mask, 0.0)
        G = q.shape[1] // k.shape[1]
        sums["o"] = torch.einsum("bhqk,bhkd->bhqd", p,
                                 v.float().abs().repeat_interleave(G, dim=1))
    return compare_with_plain({"o": o, "lse": lse}, {"o": o_p, "lse": lse_p},
                              sums, q.dtype, names=("o", "lse"))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _lib():
    from . import _native
    lib = _native.load(LIBRARY)
    if lib.hvd_flash_fwd.argtypes is None:
        # pointers as c_void_p: without argtypes ctypes would pass each
        # Python int as a 32-bit C int and cut the pointer
        tail = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        for fn, n_ptrs in ((lib.hvd_flash_fwd, 5),
                           (lib.hvd_flash_bwd_dq, 7),
                           (lib.hvd_flash_bwd_dkv, 9)):
            fn.argtypes = [ctypes.c_void_p] * n_ptrs + tail
            fn.restype = ctypes.c_int
        lib.hvd_flash_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.hvd_flash_smem_bytes.restype = ctypes.c_longlong
    return lib


def design_of(kind: str, dtype: torch.dtype, D: int) -> str:
    """The kernel function that runs ``kind`` (``"fwd"``, ``"dq"``,
    ``"dkv"``) in ``dtype`` at (padded) head dim ``D``: the tensor-core
    design (``*_bf16``), the fp32 one up to 128 (``*_f32``) or the
    CUDA-core design above 128 (``*_wide``); bf16's forward is on the
    tensor cores at every D."""
    base = {"fwd": "fwd", "dq": "bwd_dq", "dkv": "bwd_dkv"}[kind]
    if D <= NARROW_MAX_D:
        return base + ("_bf16" if dtype == torch.bfloat16 else "_f32")
    if kind == "fwd" and dtype == torch.bfloat16:
        return "fwd_bf16"
    return base + "_wide"


def _count(kind: str, dtype: torch.dtype, D: int) -> None:
    """One launch of ``kind``: its total and its design's count (keyed
    ``design/dtype``)."""
    setattr(flash_attention, f"{kind}_launches",
            getattr(flash_attention, f"{kind}_launches") + 1)
    key = f"{design_of(kind, dtype, D)}/{str(dtype).split('.')[-1]}"
    counts = flash_attention.design_launches
    counts[key] = counts.get(key, 0) + 1


def check_backward_head_dim(D: int) -> None:
    """Raise ``ValueError`` naming ``D`` when the backward kernels (K5 /
    K6) do not take head dim ``D`` (above 256)."""
    if D > MAX_HEAD_DIM["dq"]:
        raise ValueError(
            f"the flash attention backward kernels (K5 / K6) take a head "
            f"dim up to {MAX_HEAD_DIM['dq']}; got {D} for a call that "
            f"needs a gradient")


def _check_cuda(*ts: torch.Tensor, kind: str = "fwd") -> None:
    """What the kernels take: CUDA tensors of one dtype (fp32 or bf16) on
    one device, a head dim ``kind``'s kernel takes (``MAX_HEAD_DIM``), a
    contiguous head dim and, for bf16 (16-byte vector loads), every
    stride a multiple of 8 elements and 16-byte aligned data."""
    q = ts[0]
    if q.dtype not in _DTYPES:
        raise ValueError(f"the flash attention kernels take float32 or "
                         f"bfloat16; got {q.dtype}")
    D = q.shape[-1]
    if not 1 <= D <= MAX_HEAD_DIM[kind]:
        raise ValueError(f"the flash attention {kind} kernel takes a head "
                         f"dim from 1 to {MAX_HEAD_DIM[kind]}; got {D}")
    for t in ts:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"q, k, v and do must share one device and "
                             f"dtype; got {t.device} {t.dtype} against "
                             f"{q.device} {q.dtype}")
        if t.dim() != 4 or t.shape[-1] != D:
            raise ValueError(f"expected [B, heads, S, {D}]; got "
                             f"{tuple(t.shape)}")
        if max(t.shape[:3]) >= 2 ** 31:
            raise ValueError(f"{tuple(t.shape)} exceeds the kernels' int32 "
                             f"counts")


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can address it through its strides,
    else a contiguous copy."""
    if t.stride(-1) != 1:
        return t.contiguous()
    if t.dtype == torch.bfloat16 and (
            any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16):
        return t.contiguous()
    return t


def _dims(q, k, v, do, out0, out1=None, plan=(0, 0, 0)) -> ctypes.Array:
    """The C side's ``dims``: B, H, KV, Sq, Skv, D, then the (batch,
    head, row) strides of q, k, v, do, out0 and out1 (zeros where a
    kernel takes no such tensor), then K6's split plan."""
    B, H, Sq, D = q.shape
    vals = [B, H, k.shape[1], Sq, k.shape[2], D]
    for t in (q, k, v, do, out0, out1):
        vals += [0, 0, 0] if t is None else list(t.stride()[:3])
    vals += list(plan)
    return (ctypes.c_longlong * len(vals))(*vals)


def smem_bytes(kind: str, D: int) -> int:
    """Dynamic shared memory of one block of a bf16 kernel (``"fwd"``,
    ``"dq"``, ``"dkv"``) at head dim D, as the launch asks for it."""
    return int(_lib().hvd_flash_smem_bytes(("fwd", "dq", "dkv").index(kind),
                                           D))


def _empty_bshd(B, H, S, D, like: torch.Tensor) -> torch.Tensor:
    """``[B, H, S, D]`` stored as ``[B, S, H, D]``: the layout the models
    read back without a copy."""
    return torch.empty(B, S, H, D, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _raise_on(err: int, what: str, q, k) -> None:
    if err != 0:
        raise RuntimeError(
            f"flash attention {what} kernel launch failed: cudaError_t "
            f"{err} (q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype})")


def flash_fwd_kernel(q, k, v, causal: bool, scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on CUDA tensors; returns ``(o, lse)``."""
    _check_cuda(q, k, v)
    D = q.shape[-1]
    q, k, v = (_kernel_layout(t) for t in pad_head_dim(q, k, v))
    B, H, Sq, Dp = q.shape
    o = _empty_bshd(B, H, Sq, Dp, q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    if o.numel() == 0 or k.shape[2] == 0:
        # no key: o = 0 and lse = log(1e-20), as for a fully masked row
        return o[..., :D].zero_(), lse.fill_(math.log(1e-20))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with _on(q.device):
        err = _lib().hvd_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _dims(q, k, v, None, o), scale, int(causal),
            _DTYPES[q.dtype], stream)
    _raise_on(err, "forward", q, k)
    _count("fwd", q.dtype, Dp)
    return o[..., :D], lse


def flash_bwd_dq_kernel(q, k, v, do, lse, delta, causal: bool,
                        scale: float) -> torch.Tensor:
    """Launch K5; returns dq in q's dtype (and layout, at a head dim that
    is a multiple of 8)."""
    _check_cuda(q, k, v, do, kind="dq")
    D = q.shape[-1]
    q, k, v, do = (_kernel_layout(t) for t in pad_head_dim(q, k, v, do))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq[..., :D]
    if k.shape[2] == 0:
        return dq[..., :D].zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with _on(q.device):
        err = _lib().hvd_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _dims(q, k, v, do, dq), scale, int(causal),
            _DTYPES[q.dtype], stream)
    _raise_on(err, "dq", q, k)
    _count("dq", q.dtype, q.shape[-1])
    return dq[..., :D]


def flash_bwd_dkv_kernel(q, k, v, do, lse, delta, causal: bool,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6 (in bf16 its pieces, then their combine when there is more
    than one); returns ``(dk, dv)`` in k's dtype (and layout, at a head
    dim that is a multiple of 8)."""
    _check_cuda(q, k, v, do, kind="dkv")
    D = q.shape[-1]
    q, k, v, do = (_kernel_layout(t) for t in pad_head_dim(q, k, v, do))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk[..., :D], dv[..., :D]
    if q.shape[2] == 0:
        return dk[..., :D].zero_(), dv[..., :D].zero_()
    B, KV, Skv, Dp = k.shape
    G = q.shape[1] // KV
    plan = dkv_split_plan(G, q.shape[2])
    # the pieces are the bf16 design's up to NARROW_MAX_D; the wide design
    # sums the group in one launch
    nbytes = (dkv_scratch_bytes(B, KV, Skv, Dp, G, plan)
              if q.dtype == torch.bfloat16 and Dp <= NARROW_MAX_D else 0)
    scratch = (torch.empty(nbytes // 4, dtype=torch.float32, device=q.device)
               if nbytes else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with _on(q.device):
        err = _lib().hvd_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            _dims(q, k, v, do, dk, dv, plan=plan), scale,
            int(causal), _DTYPES[q.dtype], stream)
    _raise_on(err, "dk/dv", q, k)
    _count("dkv", q.dtype, Dp)
    return dk[..., :D], dv[..., :D]


def _run(kernel, plain, q, *args):
    if q.device.type == "cuda":
        return kernel(q, *args)
    if q.device.type == "cpu":
        return plain(q, *args)
    raise ValueError(f"flash attention runs on cuda or cpu; got "
                     f"{q.device}")


class _FlashAttention(torch.autograd.Function):
    """``(o, lse)``: forward K4, backward K5 + K6 with the lse cotangent
    folded into delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _run(flash_fwd_kernel, flash_fwd_plain, q, k, v, causal,
                      scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        delta = (do.float() * o.float()).sum(dim=-1)
        if dlse is not None:
            # d lse / d s = p, so the lse path adds p * dlse to ds:
            # ds = p (dp - (delta - dlse)); dv is unaffected
            delta = delta - dlse.float()
        dq = _run(flash_bwd_dq_kernel, flash_bwd_dq_plain, q, k, v, do,
                  lse, delta, ctx.causal, ctx.scale)
        dk, dv = _run(flash_bwd_dkv_kernel, flash_bwd_dkv_plain, q, k, v,
                      do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def _prepare(q, k, v, scale):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q [B, H, Sq, D] and k / v "
                         f"[B, KV, Skv, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    H, KV = q.shape[1], k.shape[1]
    if H % KV:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {KV}")
    return float(scale) if scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [B, H, Sq, D], lse [B, H, Sq] fp32)``, differentiable in both
    outputs (the lse cotangent enters as ``delta - dlse``). On the card a
    call that needs a gradient raises before its forward at a head dim
    the backward kernels do not take."""
    scale_ = _prepare(q, k, v, scale)
    if q.device.type == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        check_backward_head_dim(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), scale_)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``[B, H, Sq, D] x [B, KV, Skv, D] -> [B, H, Sq, D]`` fused
    attention, GQA-aware, differentiable through K5 / K6."""
    return flash_attention_lse(q, k, v, causal=causal, scale=scale)[0]


#: launches of K4 / K5 / K6 since the last reset (plain ints), and by
#: design and dtype (``"fwd_bf16/bfloat16"``: :func:`design_of`)
flash_attention.fwd_launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0
flash_attention.design_launches = {}


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    force: Optional[str] = None) -> torch.Tensor:
    """Dispatch: the kernels on a CUDA tensor, the dense reference
    composition on a CPU one. ``force``: ``"cuda"`` (the kernels; raises
    for a tensor off the card) or ``"reference"`` (the composition, kv
    heads expanded)."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} must be a multiple of "
                         f"kv heads {k.shape[1]}")
    mode = force
    if mode is None:
        mode = "cuda" if q.device.type == "cuda" else "reference"
    if mode == "cuda":
        if q.device.type != "cuda":
            raise ValueError(f"force='cuda' needs CUDA tensors; got "
                             f"{q.device}")
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if mode == "reference":
        k, v = expand_kv_heads(k, v, q.shape[1] // k.shape[1])
        return attention_reference(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"force must be None, 'cuda' or 'reference'; got "
                     f"{force!r}")
