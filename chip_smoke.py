"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases (any failure exits nonzero):

1. environment: versions and the card's name and power limit; builds
   every CUDA kernel of the serving path from ``horovod_tpu_torch/ops/
   csrc`` (one nvcc per source, all started together).
2. kernel vs plain: the paged-attention kernel against its plain PyTorch
   version at Llama_1B head shapes (H 32, KV 4, D 64, block 16) for the
   decode (T = 1) and prefill (T = 128, 512) steps, bf16 and fp32, with
   -1 table entries, shared and copy-on-write blocks and mid-block
   positions (max |err| <= 1e-4 fp32, 2e-2 bf16); then its time at
   decode B = 8, L = 2048 beside the plain version, one
   ``scaled_dot_product_attention`` call on the gathered KV (yardstick
   only) and the bound (bytes over 3.35 TB/s).
3. serve, full width, bf16: Llama_1B (22 layers, random weights from a
   seed), max_batch 8, block 16, max_len 2048, buckets (128, 512),
   prefix cache on; greedy requests of 64-500 prompt tokens (half share
   a 256-token system prompt), 32 new tokens each, one through
   ``POST /generate``. All must finish ok, through the CUDA kernel.
4. stream parity, full width, fp32: the same requests through the kernel
   path and through the plain path; streams must be identical except a
   divergence whose first differing step has a plain-path top-2 logit
   gap < 1e-3 (printed, not a failure).

Prints one JSON line describing each kernel, the nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``. Writes the details to
``chiprun_out/chip_smoke.json``.
"""
import argparse
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
H, KV, D, BS = 32, 4, 64, 16     # Llama_1B attention shapes
SEED, NEW_TOKENS = 0, 32         # weights/requests seed; tokens per request


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of ``fn(i)`` over ``iters`` calls (CUDA events)."""
    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def paged_case(B, T, L, dtype, seed, dev):
    """Pool, tables and positions shaped like the serve plane's: rows 0-3
    share a 256-token prefix run, row 4 holds a copy-on-write copy of a
    shared block, positions sit mid-block, unassigned entries are -1.
    Every query position lies inside its row's assigned blocks."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(seed)
    nblk = L // BS
    NB = B * nblk + 32
    pk = torch.randn(NB, BS, KV, D, generator=g, device=dev).to(dtype)
    pv = torch.randn(NB, BS, KV, D, generator=g, device=dev).to(dtype)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    free = list(rng.permutation(NB))
    shared = [free.pop() for _ in range(256 // BS)]
    tbl = np.full((B, nblk), -1, np.int32)
    pos = np.zeros(B, np.int32)
    for b in range(B):
        need = rng.randint(T, L + 1)                  # tokens this row holds
        n_b = -(-need // BS)
        own = [free.pop() for _ in range(n_b)]
        if b < 4 and n_b > len(shared):
            own[:len(shared)] = shared
        tbl[b, :n_b] = own
        pos[b] = need - T                             # last query at need-1
    if B > 4 and tbl[4, 0] >= 0:                      # CoW copy of shared[1]
        pk[tbl[4, 0]] = pk[shared[1]]
        pv[tbl[4, 0]] = pv[shared[1]]
    return (q, pk, pv, torch.from_numpy(tbl).to(dev),
            torch.from_numpy(pos).to(dev))


def check_kernel(paged, kvc, dev):
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for B, T, L in ((8, 1, 2048), (8, 128, 2048), (4, 512, 2048)):
            args = paged_case(B, T, L, dtype, seed=T + B, dev=dev)
            got = paged.paged_attention_fused(*args)
            torch.cuda.synchronize()
            want = kvc.paged_attention(*args)
            err = float((got.float() - want.float()).abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= TOL[dtype]
            results.append({"dtype": str(dtype).split(".")[-1], "B": B,
                            "T": T, "L": L, "max_abs_err": err,
                            "tol": TOL[dtype], "ok": ok})
            log(f"kernel_check dtype={results[-1]['dtype']} B={B} T={T} "
                f"L={L} max_abs_err={err:.3g} tol={TOL[dtype]} "
                f"{'ok' if ok else 'FAIL'}")
            del got, want, args
    if not all(r["ok"] for r in results):
        raise SystemExit("phase 2: kernel disagrees with its plain version")
    return results


def time_kernel(paged, kvc, dev, B, T, L, dtype):
    """Kernel, plain and library times on inputs rotated over enough
    distinct pools (> 50 MB) that L2 holds none of them between calls,
    as a layer's pool is cold when the next layer reads its own."""
    sets = []
    isz = 2 if dtype == torch.bfloat16 else 4
    nblk = L // BS
    per_set = 2 * B * L * KV * D * isz + 2 * B * T * H * D * isz
    n_sets = max(2, int(np.ceil(120e6 / per_set)))
    for s in range(n_sets):
        g = torch.Generator(device=dev).manual_seed(100 + s)
        pk = torch.randn(B * nblk, BS, KV, D, generator=g,
                         device=dev).to(dtype)
        pv = torch.randn(B * nblk, BS, KV, D, generator=g,
                         device=dev).to(dtype)
        q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
        tbl = torch.randperm(B * nblk, generator=g, device=dev).reshape(
            B, nblk).to(torch.int32)
        pos = torch.full((B,), L - T, dtype=torch.int32, device=dev)
        sets.append((q, pk, pv, tbl, pos))
    n = len(sets)
    kern = cuda_ms(lambda i: paged.paged_attention_fused(*sets[i % n]),
                   iters=40)
    plain = cuda_ms(lambda i: kvc.paged_attention(*sets[i % n]), iters=10)
    # the library yardstick: one SDPA call on KV already gathered per row
    # (the gather is not timed); [B, H, T, D] x [B, KV, L, D]
    gathered = []
    for q, pk, pv, tbl, pos in sets:
        k = pk[tbl.long()].reshape(B, L, KV, D).transpose(1, 2).contiguous()
        v = pv[tbl.long()].reshape(B, L, KV, D).transpose(1, 2).contiguous()
        gathered.append((q.transpose(1, 2).contiguous(), k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = {"is_causal": T > 1}
    if T > 1 and T != L:
        # prefill of the LAST T positions: key j valid iff j <= L - T + t
        j = torch.arange(L, device=dev)
        t = torch.arange(T, device=dev)
        kw = {"attn_mask": j[None, :] <= (L - T) + t[:, None]}
    try:
        sdpa(*gathered[0], enable_gqa=True, **kw)
        kw["enable_gqa"] = True
    except TypeError:   # a PyTorch without enable_gqa: expand the heads
        gathered = [(q, k.repeat_interleave(H // KV, 1),
                     v.repeat_interleave(H // KV, 1))
                    for q, k, v in gathered]
    lib = cuda_ms(lambda i: sdpa(*gathered[i % n], **kw), iters=40)
    # the bound: each input read once, each output written once
    keys = B * sum(L - T + t + 1 for t in range(T))      # (row, t, key)
    kv_keys = B * L                                      # distinct keys
    bytes_ = (2 * B * T * H * D * isz + 2 * kv_keys * KV * D * isz
              + B * nblk * 4 + B * 4)
    flops = 4 * keys * H * D
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    out = {"B": B, "T": T, "L": L, "dtype": str(dtype).split(".")[-1],
           "ms": kern, "plain_ms": plain, "library_ms": lib,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": bytes_, "flops": flops}
    log("kernel_time " + " ".join(f"{k}={v}" for k, v in out.items()))
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving path at full width
# ---------------------------------------------------------------------------

def make_requests(seed, n=9):
    rng = np.random.RandomState(seed)
    system = [int(t) for t in rng.randint(0, 32000, 256)]
    prompts = []
    for i in range(n):
        if i % 2 == 0:
            tail = int(rng.randint(8, 245))          # 264..500 tokens
            prompts.append(system + [int(t) for t in
                                     rng.randint(0, 32000, tail)])
        else:
            prompts.append([int(t) for t in
                            rng.randint(0, 32000, rng.randint(64, 501))])
    return prompts


def build_stack(ht, sd, dtype, kernel, dev):
    from horovod_tpu_torch.models.llama import Llama, Llama_1B
    cfg = Llama_1B(dtype=dtype, kv_block_size=BS,
                   kv_pool_blocks=ht.pool_blocks_for(8, 2048, BS),
                   decode_kernel=kernel)
    model = Llama(cfg, device=dev)
    model.load_state_dict(sd)
    ex = ht.ShardedExecutor(model, max_batch=8, max_len=2048, device=dev)
    q = ht.AdmissionQueue(max_queue=64)
    b = ht.ContinuousBatcher(ex, q, buckets=(128, 512), prefix_cache=True)
    b.warmup()
    return ex, q, b


class _Profile:
    """``torch.profiler`` over the serve phase's main path (``--profile``
    only: tracing slows every launch). Writes the per-kernel device-time
    table and the device busy share to ``chiprun_out``."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - self.t0) * 1e6
        self.prof.__exit__(*exc)
        avgs = self.prof.key_averages()
        busy_us = sum(e.self_device_time_total for e in avgs)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "serve_profile.txt"),
                  "w") as f:
            f.write(avgs.table(sort_by="self_device_time_total",
                               row_limit=30))
        log(f"profile wall_ms={wall_us / 1e3:.1f} device_busy_ms="
            f"{busy_us / 1e3:.1f} idle_share={1 - busy_us / wall_us:.3f}")
        for e in sorted(avgs, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"profile_top name={e.key[:60]!r} calls={e.count} "
                f"device_ms={e.self_device_time_total / 1e3:.2f}")
        return False


def serve_phase(ht, paged, dev, seed, new_tokens, profile=False):
    from horovod_tpu_torch.models.llama import Llama_1B
    cfg = Llama_1B(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    sd = ht.init_llama_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    ex, q, b = build_stack(ht, sd, torch.bfloat16, None, dev)
    del sd
    setup_s = time.perf_counter() - t0
    if ex.kernel != "cuda":
        raise SystemExit(f"phase 3: executor resolved kernel {ex.kernel}")
    prompts = make_requests(seed)
    # ---- the main path: counts from 0, read right after ----
    paged.paged_attention_fused.launches = 0
    srv, http_thread = ht.serve_http(b)
    http_reply = {}

    def post():
        body = json.dumps({"tokens": prompts[0],
                           "max_new_tokens": new_tokens}).encode()
        req = urllib.request.Request(
            "http://%s:%d/generate" % srv.server_address, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            http_reply.update(json.loads(r.read()), code=r.status)

    with _Profile(profile):
        t_start = time.perf_counter()
        poster = threading.Thread(target=post)
        poster.start()
        handles = [q.submit(p, max_new_tokens=new_tokens)
                   for p in prompts[1:]]
        for h in handles:
            h.wait(timeout=600)
        poster.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
    launches = paged.paged_attention_fused.launches
    srv.shutdown()
    srv.server_close()
    b.stop()
    http_thread.join(timeout=10)
    statuses = [h.status for h in handles] + [http_reply.get("status")]
    streams = [h.tokens for h in handles] + [http_reply.get("tokens", [])]
    ok = (all(s == "ok" for s in statuses)
          and all(len(s) == new_tokens and all(0 <= t < 32000 for t in s)
                  for s in streams)
          and launches > 0 and http_reply.get("code") == 200)
    gen = sum(len(s) for s in streams)
    out = {"requests": len(prompts), "statuses": statuses,
           "launches": launches, "generated_tokens": gen, "wall_s": wall,
           "tokens_per_s": gen / wall,
           "ttft_p50_ms": float(np.median(b.ttft_ms)),
           "step_p50_ms": {k: ex.p50_step_ms(k)
                           for k in ("prefill", "decode")},
           "steps": {k: len(v) for k, v in ex.step_latencies_ms.items()},
           "prefix_hits": b.prefix.hits,
           "prefix_tokens_saved": b.prefix.tokens_saved,
           "setup_s": setup_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("serve " + json.dumps(out))
    del ex, q, b
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("phase 3: serving failed: " + json.dumps(out))
    return out


def parity_phase(ht, dev, seed, new_tokens):
    from horovod_tpu_torch.models.llama import Llama_1B
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    cfg = Llama_1B(dtype=torch.float32)
    sd = ht.init_llama_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    prompts = make_requests(seed)[:8]
    streams, gaps = {}, {}
    for kernel in ("cuda", "reference"):
        ex, q, b = build_stack(ht, sd, torch.float32, kernel, dev)
        if kernel == "reference":
            # record the plain path's top-2 logit gap per (request, token)
            step = ex.step

            def traced(*a, _step=step, _b=b, _ex=ex, **kw):
                nxt = _step(*a, **kw)
                top2 = torch.topk(_ex.last_logits, 2, dim=-1).values
                gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
                for row, seq in _b._active.items():
                    if a[2][row]:
                        gaps[(seq.req.rid, len(seq.out))] = float(gap[row])
                return nxt
            ex.step = traced
        hs = [q.submit(p, max_new_tokens=new_tokens) for p in prompts]
        b.run()
        if not all(h.status == "ok" for h in hs):
            raise SystemExit(f"phase 4: {kernel} path: "
                             f"{[h.status for h in hs]}")
        streams[kernel] = [h.tokens for h in hs]
        del ex, q, b
        torch.cuda.empty_cache()
    del sd
    diverged = []
    for rid, (a, r) in enumerate(zip(streams["cuda"],
                                     streams["reference"])):
        if a == r:
            continue
        k = next(i for i, (x, y) in enumerate(zip(a, r)) if x != y)
        diverged.append({"request": rid, "step": k,
                         "plain_top2_gap": gaps.get((rid, k))})
    out = {"requests": len(prompts), "identical":
           len(prompts) - len(diverged), "diverged": diverged}
    log("parity " + json.dumps(out))
    bad = [d for d in diverged if d["plain_top2_gap"] is None
           or d["plain_top2_gap"] >= 1e-3]
    if bad:
        raise SystemExit(f"phase 4: streams diverge at a clear margin: "
                         f"{bad}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve phase with torch.profiler "
                         "(slower; writes chiprun_out/serve_profile.txt)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.ops import _native, paged
    from horovod_tpu_torch.serve import kv_cache as kvc
    dev = torch.device("cuda")
    report = {}

    # ---- phase 1: environment + build ----
    log(f"env python={sys.version.split()[0]} torch={torch.__version__} "
        f"cuda={torch.version.cuda} device={torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _native.build([paged.KERNEL_NAME])
    report["build_s"] = time.perf_counter() - t0
    log(f"build kernels={[paged.KERNEL_NAME]} seconds={report['build_s']:.2f}")

    # ---- phase 2: kernel vs plain, then times ----
    report["checks"] = check_kernel(paged, kvc, dev)
    report["decode_time"] = time_kernel(paged, kvc, dev, 8, 1, 2048,
                                        torch.bfloat16)
    report["prefill_time"] = time_kernel(paged, kvc, dev, 8, 512, 512,
                                         torch.bfloat16)

    # ---- phase 3: the main path ----
    report["serve"] = serve_phase(ht, paged, dev, SEED, NEW_TOKENS,
                                  args.profile)

    # ---- phase 4: stream parity, fp32 ----
    report["parity"] = parity_phase(ht, dev, SEED, NEW_TOKENS)

    dec = report["decode_time"]
    kernels = [{
        "name": paged.KERNEL_NAME, "route": "cuda",
        "source": paged.KERNEL_SOURCE, "replaces": paged.KERNEL_REPLACES,
        "launches": report["serve"]["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in report["checks"]
                           if c["dtype"] == "bfloat16"),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"]}]
    report.update(kernels=kernels, nvidia_smi=smi)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
