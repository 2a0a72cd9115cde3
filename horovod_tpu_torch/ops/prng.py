"""Counter-based random numbers: JAX's threefry2x32 on PyTorch tensors.

The reference draws every sampled token from ``jax.random`` keys
derived per row from ``(request seed, stream domain, draw counter)``
(``horovod_tpu/ops/pallas_paged.py`` ``_row_keys``), which is what makes
a request's token stream a function of its seed alone: the same for any
batch position, restart or replica. The port keeps that contract and
the numbers themselves. This module is JAX's default generator written
as int64 tensor ops (each 32-bit word held in an int64 and masked with
``& 0xFFFFFFFF`` after every add and shift, since CUDA's ``uint32``
tensors lack arithmetic), with the counter layout of
``jax_threefry_partitionable=True`` (JAX 0.9's default): element ``i``
of a ``random_bits`` draw hashes the 64-bit counter ``i`` split into its
high and low words, and the two output words are XORed.

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words of
JAX's raw key data. Every function is batched over the leading dims of
its keys and runs on the keys' device; nothing here keeps global state,
reads a device value on the host or copies a host value to the device
(a Python constant enters as a fill on the device), so a draw can be
captured in a CUDA graph.

* :func:`prng_key` — ``jax.random.PRNGKey(seed)`` for uint32 seeds;
* :func:`fold_in` — ``jax.random.fold_in``;
* :func:`random_bits` — ``jax.random.bits`` (32-bit);
* :func:`uniform` — ``jax.random.uniform`` (float32, any ``minval`` /
  ``maxval``);
* :func:`gumbel` / :func:`categorical` — ``jax.random.gumbel`` /
  ``categorical`` in their default ("low") mode;
* :func:`row_keys` and the ``STREAM_*`` domains — the reference's
  ``_row_keys``.

The bits and uniforms equal JAX's exactly. Gumbel noise goes through
``log`` twice, which the port rounds correctly and XLA's CPU log does
not (they differ by an ulp on about one input in seven), so a
categorical draw can differ where two candidates' perturbed scores tie
to within that.
"""
from __future__ import annotations

from typing import Sequence

import torch

MASK = 0xFFFFFFFF
#: the threefry key-schedule parity constant
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32's smallest normal (``jnp.finfo(float32).tiny``): gumbel's
#: ``minval``
TINY = float(torch.finfo(torch.float32).tiny)

#: key-stream domains, one per consumer of randomness, so draft
#: proposals, accept uniforms and residual draws are independent (the
#: rejection-sampling correctness requirement); the reference's values
STREAM_SAMPLE = 0     # plain sampling: prefill, decode, bonus/full draws
STREAM_DRAFT = 1      # draft executors' proposal draws
STREAM_ACCEPT = 2     # speculative accept uniforms
STREAM_RESIDUAL = 3   # speculative residual draws


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function (20 rounds), elementwise over
    broadcast int64 tensors holding uint32 values; returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` of each uint32 value in ``seed`` (any
    integer tensor): ``[..., 2]`` = (high word, low word) = (0, seed)."""
    s = seed.to(torch.int64) & MASK
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    pair (0, data); ``data`` an int or an integer tensor broadcast against
    the keys' leading dims."""
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & MASK
    else:
        d = torch.full((), int(data) & MASK, dtype=torch.int64,
                       device=key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()
                ) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit) for each key: int64
    ``[*key.shape[:-1], *shape]`` of uint32 values. Element i hashes the
    64-bit counter i as (high word, low word), and the two outputs are
    XORed (the partitionable layout)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(
        shape)
    view = tuple(key.shape[:-1]) + (1,) * len(shape)
    k1, k2 = key[..., 0].reshape(view), key[..., 1].reshape(view)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for
    each key: the top 23 bits as the mantissa of a float in [1, 2), minus
    1, scaled, shifted and floored at ``minval``, in float32. XLA fuses
    the scale and the shift into one fused multiply-add (one rounding);
    the product of two floats is exact in float64, so the sum is taken
    there and rounded to float32 once."""
    bits = random_bits(key, shape)
    f = (((bits >> 9) | 0x3F800000).to(torch.int32)
         .view(torch.float32) - 1.0)
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def _log32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log``, correctly rounded: taken in float64 and rounded
    once. (A float32 ``torch.log`` on the CPU is within an ulp too, but
    its first call in a process has been seen to run at ~1e-4 relative
    error when JAX shares the process; float64 leaves that error below
    float32's resolution.)"""
    return torch.log(x.double()).float()


def gumbel(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in its default ("low") mode:
    ``-log(-log(u))`` with u uniform in [tiny, 1), each log rounded to
    float32 as JAX's are."""
    return -_log32(-_log32(uniform(key, shape, TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, one
    draw per key: ``argmax(gumbel + logits)`` (the first index on ties);
    ``-inf`` logits are never drawn. ``key [..., 2]`` pairs with
    ``logits [..., V]``. Returns int64 indices."""
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)


def row_keys(seed: torch.Tensor, stream: int, ctr: torch.Tensor
             ) -> torch.Tensor:
    """Per-row keys from (request seed, stream domain, per-row draw
    counter), the reference's ``_row_keys``: ``fold_in(fold_in(
    PRNGKey(seed), stream), ctr)``. Nothing in them depends on the row's
    batch position, which is what makes a request's stream deterministic
    across placements and restarts."""
    return fold_in(fold_in(prng_key(seed), stream), ctr)
