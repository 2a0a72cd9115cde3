// Flash attention, forward (K4) and backward (K5: dQ, K6: dK/dV), written
// by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernels of horovod_tpu/ops/pallas_attention.py:
//   hvd_flash_fwd     <- _fwd_kernel      (:72, called at :142)
//   hvd_flash_bwd_dq  <- _bwd_dq_kernel   (:163, called at :387)
//   hvd_flash_bwd_dkv <- _bwd_dkv_kernel  (:205, called at :406)
// Same functions, for q [B, H, Sq, D] and k / v [B, KV, Skv, D] (query head h
// reads kv head h / G, G = H / KV), s = scale * q.k:
//   forward: o = softmax(s) v by the online softmax, lse = m + log(max(l,
//            1e-20)); a row that sees no key gives o = 0, lse = log(1e-20).
//   dQ:      p = exp(s - lse) under the mask, ds = p (do.v - delta),
//            dq = scale * ds k.
//   dK/dV:   per key, summed over the G query heads of its group and over
//            the queries that see it: dv = p^T do, dk = scale * ds^T q.
// The causal mask is top-left aligned (query i sees key j iff i >= j, also
// when Sq != Skv); ragged lengths are masked by their real bounds, nothing
// is padded in memory. delta = rowsum(do * o) (minus the lse cotangent) is
// computed by the caller.
//
// What bounds it on this card: the operations. At the training shapes
// (S 1024-2048, D 64) the causal forward does 2 * 2 * B*H*S^2/2 * D flops on
// O(S * D) bytes per head, some 300 flops per byte against the H100's ridge
// of ~295 (bf16, 989 TFLOP/s over 3.35 TB/s): the floor is flops over the
// tensor cores' rate. The backward does 2.5x the forward's flops.
//
// K4 (bf16), redesigned for Hopper. What bounded its first design
// (FlashAttention-2's warp layout on mma.sync m16n8k16; at Llama_1B, B 4,
// H 32, KV 4, S 2048 on an NVIDIA H100 80GB HBM3 at 700 W: 0.7426 ms,
// 4.1x one SDPA forward and 10.7x its bound): each K and V tile loaded
// synchronously between two barriers, so no copy overlapped a product;
// and every warp read the whole K and V tile from shared memory in 32-bit
// fragment loads, the shared-memory bandwidth K5 / K6 ran out of. What
// the design does:
//   * One warpgroup per 64 query rows, the grid one dimension with the
//     heaviest causal tiles first; the Q tile is copied once. Causal
//     blocks stop at the diagonal.
//   * 128-key K / V tiles (64 at D 128, where a tile is two panels) flow
//     through a 2-stage cp.async ring into swizzled tiles, rows past Skv
//     zero-filled; tile i + 1 is in flight while tile i is multiplied.
//   * s = q k^T on wgmma m64n128k16 with Q and K K-major from shared
//     memory; the online softmax runs on the accumulator in registers, and
//     p, repacked to bf16 in place, is the A operand of o += p v (V
//     MN-major). fp32 accumulation.
//   * The softmax tests each element against the masks only on an edge
//     tile (the warp's causal limit or the end of the keys); elsewhere it
//     is a row max, one fma and one ex2 an element, and a warp whose rows
//     keep their max skips rescaling o. Each thread's 16-byte copies are
//     planned once (a thread's rows share a swizzle phase), so a copy is a
//     compare and an address add. In builds of this file that tested the
//     masks on every tile and worked out each copy's swizzled offset and
//     64-bit address anew, those two took more time than both products
//     (timed with the work taken out of patched copies, not kept).
// The alternatives, each a build of this kernel checked and timed by
// `python3 chip_smoke.py --flash` in bf16 at D 64 and then taken out
// (host loop / CUDA graph ms at Llama_1B, then graph ms at GPT-2-small
// B 8, H 12, S 1024; NVIDIA H100 80GB HBM3 at 700 W, one call): the
// design above 0.2104 / 0.2033, 0.0518; a 3-stage ring 0.2517
// / 0.2413, 0.0601 (3 blocks an SM fit in shared memory, not 3 x 1.4);
// 64-key tiles 0.2236 / 0.2174, 0.0503; two warpgroups a block sharing
// the ring (128 query rows halve the K / V traffic per query) 0.2312 /
// 0.2256, 0.0541; tile i + 1's q k^T issued before tile i's softmax and
// run beside its p v (FA3's intra-warpgroup overlap, 3 stages) 0.2750 /
// 0.2695, 0.0621. One SDPA forward in the same call: 0.1873 / 0.1823 at
// Llama_1B, 0.0500 / 0.0482 at GPT-2-small.
//
// K5 and K6 (bf16), redesigned for Hopper. What bounded their first design
// (the same warp layout; at Llama_1B, B 4, H 32, KV 4, S 2048 on an NVIDIA
// H100 80GB HBM3 at 700 W: K5 0.7654 ms, K6 1.8621 ms): K6's grid was (key
// tiles, KV, B) = 512 blocks, and the first key tile's block walked all 8
// heads of its group x 32 query tiles = 256 tiles in turn; both kernels
// loaded every tile synchronously between two barriers; and mma.sync,
// where each warp reads its whole B operand from shared memory, feeds the
// tensor cores more slowly than they multiply. What the design does:
//   * K6 runs in pieces (ops/attention.py dkv_split_plan, from shapes only):
//     a piece is a share of the GQA group's query heads and a chunk of the
//     query tiles, so no block walks more than DKV_MAX_TILES = 64 tiles (4
//     pieces of 2 heads at Llama_1B: 2048 blocks). Each piece writes fp32
//     partials of dk (without the scale) and dv to a scratch the wrapper
//     allocates (2 x pieces x B x KV x Skv x D floats, 64 MiB at
//     Llama_1B), and dkv_combine sums them in piece order, scales dk and
//     casts once: no atomics, the same bits on every run. With one piece
//     (G 1 at S <= 4096) the block writes dk / dv itself and there is no
//     second launch. The grids are one dimension with the heaviest causal
//     tiles first: K6's key tiles from the first, K5's query tiles from the
//     last.
//   * A two-stage ring in shared memory filled by cp.async.cg 16-byte
//     copies (commit / wait groups; fence.proxy.async before wgmma reads):
//     K5 streams its K / V tiles, K6 its Q, dO, lse and delta tiles; tile
//     i + 1 loads while tile i is multiplied. Rows past a ragged edge are
//     zero-filled by the copy (src-size 0) and never read.
//   * The products run on wgmma, one warpgroup of 4 warps per block over
//     64 rows (K5: queries, K6: keys), fp32 accumulation. The score-shaped
//     products (q k^T and do v^T; k q^T and v do^T in K6) read both
//     operands from shared memory (m64n64k16, both K-major); the second
//     products (ds k in K5; p^T do and ds^T q in K6) take p / ds from
//     registers, the score accumulators repacked to bf16 in place (the
//     accumulator and A-operand layouts agree), and B from shared memory
//     MN-major (m64nDk16). So a tile is read from shared memory once per
//     block, not once per warp, and no fragment is loaded by hand: wgmma
//     takes the place of ldmatrix.
//   * Tiles are stored swizzled for the descriptors: rows of 2 min(D, 64)
//     bytes, the 16-byte chunk c of row r at chunk c ^ (row bits), the
//     128-byte swizzle at D >= 64 (64- and 32-byte at D 32 / 16; D 128 as
//     two 64-column panels). The swizzle spreads the rows that share a
//     column chunk over distinct bank groups, for the copies and for wgmma.
// Choices, each timed by `python3 chip_smoke.py --flash` (K5 / K6 ms, host
// loop, at Llama_1B on an NVIDIA H100 80GB HBM3 at 700 W, K4 0.735-0.754
// ms as the control in every call; the alternatives are earlier builds of
// this file). mma.sync with ldmatrix.x4(.trans) fragments, the same rings
// and pieces, tuned for occupancy: 0.428 / 0.663 against wgmma's 0.366 /
// 0.518 in the same call. One warpgroup a block against two
// sharing each ring tile (128 rows or keys): 0.391 / 0.544 against 0.515 /
// 0.672. K5 at 4 blocks an SM (128 registers, a few spills) against 3:
// 0.335 against 0.372; K6 at 3 (168 registers) against 4: 0.516 against
// 0.691 (spills). K6 in 4 pieces of 2 heads against 8 of one head and 16
// half-range pieces: 0.516 against 0.556 and 0.632 (the scratch doubles
// each time).
// Not done yet (later work): TMA and a warp-specialised producer, keeping
// several products in flight across tiles, a persistent schedule, and
// K5 / K6 on K4's copy plan and edge-only masks.
//
// Head dims: every multiple of 8 from 8 to 512 for K4, to 256 for K5 / K6.
// In bf16 K4 runs fwd_bf16 at every D (above 128 at DS 256, above 256 in
// two output column parts; see K4's note below); above 128 K5 / K6 in
// both dtypes and K4 in fp32 run on one simple design per kernel (the
// section "head dims 129 .. 512" below). Up to 128, an instance is built
// for a stored width DS of 16, 32, 64 or 128 (stored_dim: the smallest
// that holds D) and takes D at run time: at D < DS the Q, K, V and dO tiles' columns
// D .. DS - 1 are zero-filled by the copy (src-size 0), the products with
// K = D run DS / 16 k steps over them, those with N = D run at N = DS
// (reading the zero columns) and only the first D columns are written;
// K6's scratch and combine stay at the true D. D % 8 == 0 keeps every bf16
// row a whole number of 16-byte chunks, so the copies stay 16 bytes; any
// other D up to 128 reaches the kernels zero-padded to the next multiple
// of 8 by the wrapper (ops/attention.py pad_head_dim, a copy). At D
// == DS the padding is a compile-time branch (the PAD template argument)
// and the code is that of an instance built for D. wgmma's depth is 16, so
// D 8 runs on D-16 tiles; an N-8 product (m64n8k16) would read half a
// 32-byte swizzle atom of an MN-major tile, a layout the canonical wgmma
// layouts do not include. A padded D pays for DS: D 72 runs on the D-128
// instance.
//
// fp32 tensors are computed in fp32 on the CUDA cores (four threads per
// row, each owning every fourth element of the head dim), as the TPU
// kernel upcasts everything: these kernels serve the fp32 parity runs, not
// the bf16 training path. The softmax statistics, lse, delta and every
// accumulator are fp32 in both types.
//
// Every tensor is addressed through its batch, head and row strides (in
// elements; the head dim is contiguous), so views such as a slice of a
// fused qkv projection or a [B, S, H, D] buffer seen as [B, H, S, D] are read
// and written in place. The bf16 kernels load 16-byte vectors and need every
// stride a multiple of 8 elements; the wrapper checks that.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// Binding: ctypes, see horovod_tpu_torch/ops/attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kMaskedBelow = kNegInf / 2;
constexpr int kTile = 64;          // rows of a block, keys / queries of a tile
constexpr int kF32Threads = 256;   // 64 rows x 4 threads
constexpr int kF32Tile = 32;       // keys / queries per fp32 tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;   // o (K4), dq (K5), dk (K6)
  void* out1;   // dv (K6)
  float* lse;   // K4
  float* scratch;  // K6's fp32 partials, when it runs in pieces
  long long qs[3], ks[3], vs[3], dos[3], o0s[3], o1s[3];  // b, h, row
  int B, H, KV, G, Sq, Skv;
  float scale;
  int causal;
  int D;  // the head dim; a kernel instance stores DS >= D columns
  // K6's split: heads per piece, query tiles per chunk, chunks, pieces
  int hp, chunk, n_chunks, n_pieces;
};

__device__ __forceinline__ bool masked(const Params& p, int qpos, int kpos) {
  return (p.causal && kpos > qpos) || kpos >= p.Skv || qpos >= p.Sq;
}

// ---------------------------------------------------------------------------
// bf16: cp.async tile rings feeding wgmma (K4, K5, K6)
// ---------------------------------------------------------------------------

constexpr int kQueryTile = 64;  // queries of a K6 tile

// The stored width DS of head dim D (a multiple of 8): the smallest of 16,
// 32, 64, 128 and 256 that holds it, 256 above that (K4's column chunks). A
// kernel instance is built for DS; at D < DS (PAD) its tiles' columns D ..
// DS - 1 are zero-filled by the copy and only columns < D are written.
// wgmma's depth is 16, so D 8 runs on D-16 tiles.
__host__ __device__ constexpr int stored_dim(int D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows g and g + 8 of a warp's 16-row slice of a wgmma accumulator (DS
// columns; n8 block jd at acc[jd]), times `mul[r]`, as bf16 at out + row *
// rs (row r of the two below `rows[r]`, skipped past `n`); only the first
// D columns (D == DS unless PAD).
template <int DS, bool PAD>
__device__ __forceinline__ void store_rows(uint16_t* out, long long rs,
                                           const float (*acc)[4],
                                           const int* rows, const float* mul,
                                           int n, int lane, int D) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= n) continue;
    uint16_t* o = out + rows[r] * rs + 2 * (lane & 3);
#pragma unroll
    for (int jd = 0; jd < DS / 8; ++jd)
      if (!PAD || jd * 8 < D)
        *reinterpret_cast<uint32_t*>(o + jd * 8) =
            pack_bf16(acc[jd][2 * r] * mul[r], acc[jd][2 * r + 1] * mul[r]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with pred false nothing is
// read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
// 4 bytes, the same way
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kQueryTile fp32 row statistics (lse or delta), zeros past `valid`
template <int THREADS>
__device__ __forceinline__ void cp_stats(float* sm, const float* g,
                                         int valid) {
  for (int i = threadIdx.x; i < kQueryTile; i += THREADS)
    cp_async4(sm + i, g + (i < valid ? i : 0), i < valid);
}

template <int N>
__device__ __forceinline__ void zero_frags(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A tile of 64 rows x D bf16 laid out for wgmma (D a multiple of 16):
// panels of 64 columns (one when D <= 64), rows kRowBytes = 2 min(D, 64)
// bytes apart, and the 16-byte chunk c of row r stored at chunk c ^ ((r
// kRowBytes >> 7) & (kChunks - 1)): the 128-, 64- or 32-byte swizzle
// (descriptor mode 1, 2, 3). The tile starts on a multiple of 1024 bytes.
template <int D>
struct Swz {
  static constexpr int kRowBytes = (D < 64 ? D : 64) * 2;
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kPanelBytes = 64 * kRowBytes;
  static constexpr int kTileBytes = 64 * D * 2;
  static constexpr uint64_t kMode =
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  // byte offset of elements (r, c .. c + 7), c a multiple of 8
  __device__ static __forceinline__ int offset(int r, int c) {
    const int a = r * kRowBytes + (c % 64) / 8 * 16;
    return c / 64 * kPanelBytes + (a ^ (((a >> 7) & (kChunks - 1)) << 4));
  }
};

// 64 rows of D bf16 from global (row stride rs) into a swizzled tile of
// DS columns, asynchronously; rows at or past `valid`, and columns past D
// (PAD), are zero-filled and never read from global memory
template <int DS, bool PAD, int THREADS>
__device__ __forceinline__ void cp_tile_swz(uint8_t* sm, const uint16_t* g,
                                            long long rs, int valid, int D) {
  constexpr int kVecs = DS / 8;
  for (int i = threadIdx.x; i < 64 * kVecs; i += THREADS) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    const bool in = r < valid && (!PAD || c < D);
    cp_async16(sm + Swz<DS>::offset(r, c), g + (in ? r : 0) * rs + c, in);
  }
}

template <int D>
__device__ __forceinline__ uint64_t wgmma_desc(const uint8_t* p, int lbo,
                                               int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32 |
         Swz<D>::kMode << 62;
}

// The tile as a K-major operand (its rows are M or N, its D columns K), k
// step kk: columns [16 kk, 16 kk + 16)
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile, int kk) {
  return wgmma_desc<D>(tile + kk / 4 * Swz<D>::kPanelBytes + kk % 4 * 32, 16,
                       8 * Swz<D>::kRowBytes);
}

// The tile as an MN-major B operand (rows are K, the D columns N), k step
// kk: rows [16 kk, 16 kk + 16)
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(const uint8_t* tile,
                                                 int kk) {
  return wgmma_desc<D>(tile + kk * 16 * Swz<D>::kRowBytes,
                       Swz<D>::kPanelBytes, 8 * Swz<D>::kRowBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async writes shared memory through the generic proxy; wgmma reads it
// through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from touching accumulators across an async product
template <int N>
__device__ __forceinline__ void hold(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate);

// d (m64n64, fp32) += A * B^T, A and B K-major in shared memory
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n128, fp32) += A * B^T, A and B K-major in shared memory
template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

// d (m64n16, fp32) += A * B, A in registers, B MN-major in shared memory
template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n32, fp32) += A * B, A in registers, B MN-major in shared memory
template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n64, fp32) += A * B, A in registers, B MN-major in shared memory
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n128, fp32) += A * B, A in registers, B MN-major in shared memory
template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}



// The bf16 A fragments (k steps of 16 columns) of a warp's 16-row score
// fragments, for the register-A wgmma: the accumulator and A-operand
// layouts agree, so the scores are repacked in place
template <int KSTEPS>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float (*s)[4]) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// ---------------------------------------------------------------------------
// K4 (bf16): the forward
// ---------------------------------------------------------------------------

// The online softmax of one warp's 16 rows over a tile of KT keys, scores
// s in registers (wgmma's accumulator: rows g and g + 8, n8 block j). The
// reference's rules (pallas_attention.py:98-106) in log2 units: x = s *
// scale * log2(e), masked to NEG_INF; m' = max(m, row max); safe = 0 where
// m' is masked, else m'; corr = 0 where m was masked, else 2^min(m - safe,
// 0); p = 0 where x is masked, else 2^(x - safe). Leaves p in s, rescales
// l by corr and adds the row sums, moves m to m', and returns corr for the
// caller to apply to o. Only an edge tile (MASK) tests each element. On
// any other tile no x is masked and m' is a real score, so the rules
// reduce to p = 2^(x - m'); with sl2 > 0 the row max of x is that of s
// times sl2, and x - m' is one fma.
template <int KT, bool MASK>
__device__ __forceinline__ void online_softmax(float (*s)[4], float* m,
                                               float* l, float* corr,
                                               const Params& p,
                                               const int* rows, int k0,
                                               float sl2, int t) {
  float mx[2];
  if (MASK) {
    mx[0] = m[0];
    mx[1] = m[1];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (masked(p, rows[e >> 1], k0 + j * 8 + 2 * t + (e & 1)))
          x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
  } else {
    mx[0] = mx[1] = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  }
  float safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    if (!MASK) mx[r] = fmaxf(m[r], mx[r] * sl2);
    safe[r] = !MASK || mx[r] > kMaskedBelow ? mx[r] : 0.f;
    corr[r] = m[r] <= kMaskedBelow ? 0.f : ex2(fminf(m[r] - safe[r], 0.f));
    l[r] *= corr[r];
    m[r] = mx[r];
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two chains a row
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[j][e];
      const float pe = !MASK ? ex2(fmaf(x, sl2, -safe[e >> 1]))
                       : x <= kMaskedBelow ? 0.f
                                           : ex2(x - safe[e >> 1]);
      s[j][e] = pe;
      sum[e >> 1][j & 1] += pe;
    }
  l[0] += sum[0][0] + sum[0][1];
  l[1] += sum[1][0] + sum[1][1];
}

// acc's rows times c (a warp whose rows all keep their max skips it: a
// product by 1 changes no bit)
template <int N>
__device__ __forceinline__ void scale_rows(float (*acc)[4], const float* c) {
  if (__all_sync(0xffffffffu, c[0] == 1.f && c[1] == 1.f)) return;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    acc[j][0] *= c[0];
    acc[j][1] *= c[0];
    acc[j][2] *= c[1];
    acc[j][3] *= c[1];
  }
}

// One thread's share of the 16-byte copies of a 64-row tile into a
// swizzled tile (THREADS threads, kVecs chunks a row): TPR threads a row,
// each with CPT chunks of it (columns c0 + i TPR 8), on rows r0 + j R for
// j < J. The swizzle repeats every 8 rows and R is a multiple of 8, so
// chunk (i, j) lands j R rows below chunk (i, 0): the offsets are worked
// out once, and a copy costs a compare and an address add.
template <int DS, bool PAD, int THREADS = 128>
struct TileCopy {
  static constexpr int kVecs = DS / 8;
  static constexpr int TPR = kVecs < THREADS / 8 ? kVecs : THREADS / 8;
  static constexpr int R = THREADS / TPR, J = 64 / R, CPT = kVecs / TPR;
  static_assert(R % 8 == 0 && 64 % R == 0 && kVecs % TPR == 0,
                "a thread's rows share a swizzle");
  int r0, c0, soff[CPT];
  __device__ __forceinline__ TileCopy()
      : r0(threadIdx.x / TPR), c0(threadIdx.x % TPR * 8) {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      soff[i] = Swz<DS>::offset(r0, c0 + i * TPR * 8);
  }
  // rows [0, 64) of g (row stride rs) into the tile at sm, asynchronously;
  // rows at or past `valid`, and columns at or past `lim` (PAD),
  // zero-filled
  __device__ __forceinline__ void operator()(uint8_t* sm, const uint16_t* g,
                                             long long rs, int valid,
                                             int lim) const {
    const uint16_t* src = g + r0 * rs + c0;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const bool col = !PAD || c0 + i * TPR * 8 < lim;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const bool in = col && r0 + j * R < valid;
        cp_async16(sm + soff[i] + j * R * Swz<DS>::kRowBytes,
                   in ? src + i * TPR * 8 + j * R * rs : g, in);
      }
    }
  }
};

// K4: o and lse for 64 query rows of one head per warpgroup (warp w owns
// rows 16 w .. 16 w + 15 of its products). The Q tile is copied once; K /
// V tiles of fwd_kt(DS) keys flow through a cp.async ring, tile i + 1 in
// flight while tile i is multiplied. s = q k^T reads Q and K from shared
// memory (both K-major); o += p v takes p from registers (the scores
// repacked to bf16) and V MN-major.
//
// At DS 256 (head dims 136 .. 256, Gemma's 256) a 64 x 256 fp32 o is 128
// registers a thread of a warpgroup, and the Q tile and one K / V pair of
// 64 keys take 32 + 64 KB: two warpgroups of 64 query rows share every K /
// V tile (128 query rows a block, each K / V byte serves twice the
// queries), with a 2-stage ring: 64 + 128 KB, one block an SM. o += p v
// runs as two n128 products, one per half of V's four 64-column panels.
// A causal warpgroup skips a tile that lies wholly past its last row.
// This replaces fwd_wide for bf16 (16 query rows a block on the CUDA
// cores, a shared-memory read a fma): at Gemma-2B's attention (B 4,
// S 2048, H 8, KV 1, D 256, causal; chip_smoke.py phase 8 on an NVIDIA
// H100 80GB HBM3 at 700 W) 0.2000 ms against fwd_wide's 10.23 and one
// SDPA forward's 0.1478, 2.9x the operation bound; 214 registers, no
// spills.
//
// Above 256 (NC = 2 column chunks, D up to 512) the grid's second
// dimension takes the output's 256-column parts: each part computes the
// full s over both chunks of Q and K (K's chunks in one stage, beside V's
// columns of the part), accumulates only its own o columns, and part 0
// writes lse; one warpgroup, one stage: 64 + 96 KB. Recomputing s once a
// part is the price of the split (D 512 at the same shape: 0.7439 ms,
// 255 registers, no spills).
__host__ __device__ constexpr int fwd_kt(int DS) {
  return DS <= 64 ? 128 : 64;
}
// warpgroups of 64 query rows a block, and the ring's stages
__host__ __device__ constexpr int fwd_wgs(int DS, int NC) {
  return DS == 256 && NC == 1 ? 2 : 1;
}
__host__ __device__ constexpr int fwd_stages(int NC) {
  return NC == 1 ? 2 : 1;
}
// threads and blocks an SM of a launch's bounds
__host__ __device__ constexpr int fwd_threads(int DS, int NC) {
  return 128 * fwd_wgs(DS, NC);
}
__host__ __device__ constexpr int fwd_blocks(int DS) {
  return DS <= 64 ? 3 : DS == 128 ? 2 : 1;
}
// dynamic shared memory of one block: the warpgroups' Q chunks, then each
// stage's K chunks and V part, 1024-byte aligned
__host__ __device__ constexpr size_t fwd_smem(int DS, int NC) {
  return 1024 + (size_t)(fwd_wgs(DS, NC) * NC +
                         fwd_stages(NC) * (NC + 1) * fwd_kt(DS) / 64) *
                    64 * DS * 2;
}

// o += p v for one 16-key k step: V's DS columns at N = DS, or at DS 256
// as two n128 products over panels 0-1 and 2-3
template <int DS>
__device__ __forceinline__ void wgmma_pv(float (*o)[4], const uint32_t* pa,
                                         const uint8_t* sV, int kk) {
  if constexpr (DS == 256) {
    wgmma_rs<128>(&o[0][0], pa, desc_mnmajor<DS>(sV, kk));
    wgmma_rs<128>(&o[16][0], pa,
                  desc_mnmajor<DS>(sV + 2 * Swz<DS>::kPanelBytes, kk));
  } else {
    wgmma_rs<DS>(&o[0][0], pa, desc_mnmajor<DS>(sV, kk));
  }
}

template <int DS, bool PAD, int NC>
__global__ void __launch_bounds__(fwd_threads(DS, NC), fwd_blocks(DS))
fwd_bf16(Params p) {
  constexpr int WG = fwd_wgs(DS, NC), STAGES = fwd_stages(NC);
  constexpr int TB = Swz<DS>::kTileBytes, KT = fwd_kt(DS);
  constexpr int KTB = TB * KT / 64;    // a K or V tile of KT keys
  constexpr int STB = (NC + 1) * KTB;  // a stage: K's NC chunks, then V
  const int D = PAD ? p.D : NC * DS;
  extern __shared__ __align__(16) uint8_t smem_w[];
  uint8_t* sQ = smem_w + ((1024 - (smem_u32(smem_w) & 1023)) & 1023);
  uint8_t* sKV = sQ + WG * NC * TB;  // warpgroup w's chunk c at (w NC + c)
  int lin = blockIdx.x;
  const int h = lin % p.H;
  lin /= p.H;
  const int b = lin % p.B, kvh = h / p.G;
  const int qt = (p.Sq + 64 * WG - 1) / (64 * WG) - 1 - lin / p.B;
  const int c0 = blockIdx.y * DS;  // this block's output columns
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qt * 64 * WG, wq0 = q0 + 64 * wg, w0 = wq0 + warp * 16;
  const uint16_t* qg = (const uint16_t*)p.q + b * p.qs[0] + h * p.qs[1];
  const uint16_t* kg = (const uint16_t*)p.k + b * p.ks[0] + kvh * p.ks[1];
  const uint16_t* vg = (const uint16_t*)p.v + b * p.vs[0] + kvh * p.vs[1];
  const TileCopy<DS, PAD, 128 * WG> copy;
#pragma unroll
  for (int w = 0; w < WG; ++w) {
    const int qr = q0 + 64 * w, qr0 = qr < p.Sq ? qr : 0;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      copy(sQ + (w * NC + c) * TB, qg + qr0 * p.qs[2] + c * DS, p.qs[2],
           p.Sq - qr, D - c * DS);
  }
  cp_async_commit();
  const int nk = p.causal ? min(p.Skv, q0 + 64 * WG) : p.Skv;
  const int ntiles = (nk + KT - 1) / KT;
  auto load_kv = [&](int i) {
    uint8_t* st = sKV + (i % STAGES) * STB;
#pragma unroll
    for (int part = 0; part < KT / 64; ++part) {
      const int kr = i * KT + part * 64, kr0 = kr < p.Skv ? kr : 0;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        copy(st + c * KTB + part * TB, kg + kr0 * p.ks[2] + c * DS, p.ks[2],
             p.Skv - kr, D - c * DS);
      copy(st + NC * KTB + part * TB, vg + kr0 * p.vs[2] + c0, p.vs[2],
           p.Skv - kr, D - c0);
    }
  };
  if (ntiles > 0) load_kv(0);
  cp_async_commit();
  const int rows[2] = {w0 + g, w0 + g + 8};
  const float sl2 = p.scale * kLog2e;
  const uint8_t* sQw = sQ + wg * NC * TB;
  float o[DS / 8][4];
  zero_frags<DS / 8>(o);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  for (int i = 0; i < ntiles; ++i) {
    if constexpr (STAGES == 2) {
      if (i + 1 < ntiles) load_kv(i + 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile i has landed
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const uint8_t* sK = sKV + (i % STAGES) * STB;
    const int k0 = i * KT;
    // a causal warpgroup whose last row lies before the tile has nothing
    // in it (uniform across the warpgroup, as wgmma needs)
    if (!p.causal || k0 <= wq0 + 63) {
      float s[KT / 8][4];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < DS / 16; ++kk)
          wgmma_ss<KT>(&s[0][0], desc_kmajor<DS>(sQw + c * TB, kk),
                       desc_kmajor<DS>(sK + c * KTB, kk), c > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      hold<KT / 2>(&s[0][0]);
      // the masked softmax only on a tile that crosses the warp's causal
      // limit or the end of the keys
      if ((p.causal && k0 + KT - 1 > w0) || k0 + KT > p.Skv || !(sl2 > 0.f))
        online_softmax<KT, true>(s, m, l, corr, p, rows, k0, sl2, t);
      else
        online_softmax<KT, false>(s, m, l, corr, p, rows, k0, sl2, t);
      scale_rows<DS / 8>(o, corr);
      uint32_t pa[KT / 16][4];
      pack_a<KT / 16>(pa, s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_pv<DS>(o, pa[kk], sK + NC * KTB, kk);
      wgmma_commit();
      wgmma_wait_all();
      hold<DS / 2>(&o[0][0]);
    }
    __syncthreads();  // every warp is done with this stage
    if constexpr (STAGES == 1) {
      if (i + 1 < ntiles) load_kv(i + 1);
      cp_async_commit();
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(l[r], 1e-20f);
  }
  store_rows<DS, PAD>((uint16_t*)p.out0 + b * p.o0s[0] + h * p.o0s[1] + c0,
                      p.o0s[2], o, rows, inv, p.Sq, lane, D - c0);
  if (t == 0 && blockIdx.y == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < p.Sq) {
        const float sm = m[r] <= kMaskedBelow ? 0.f : m[r] * kLn2;
        p.lse[((long long)b * p.H + h) * p.Sq + rows[r]] =
            sm + logf(fmaxf(l[r], 1e-20f));
      }
  }
}

// K5: dq for 64 query rows of one head per block, one warpgroup (warp w
// owns rows 16 w .. 16 w + 15 of every product). The 64-key K / V tiles go
// through a two-stage cp.async ring: tile i + 1 loads while tile i is
// multiplied. s = q k^T and dp = do v^T read Q, dO, K and V from shared
// memory; dq += ds k takes ds from registers.
template <int DS, bool PAD>
__global__ void __launch_bounds__(128, DS <= 64 ? 4 : 2)
bwd_dq_bf16(Params p) {
  constexpr int TB = Swz<DS>::kTileBytes;
  const int D = PAD ? p.D : DS;
  extern __shared__ __align__(16) uint8_t smem_w[];
  uint8_t* sQ = smem_w + ((1024 - (smem_u32(smem_w) & 1023)) & 1023);
  uint8_t* sDO = sQ + TB;
  uint8_t* sKV = sDO + TB;  // stage s: K at 2 s TB, V after it
  int lin = blockIdx.x;
  const int h = lin % p.H;
  lin /= p.H;
  const int b = lin % p.B, kvh = h / p.G;
  const int qt = (p.Sq + 63) / 64 - 1 - lin / p.B;  // heaviest tiles first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * 64, w0 = q0 + warp * 16;
  const uint16_t* kg = (const uint16_t*)p.k + b * p.ks[0] + kvh * p.ks[1];
  const uint16_t* vg = (const uint16_t*)p.v + b * p.vs[0] + kvh * p.vs[1];
  cp_tile_swz<DS, PAD, 128>(sQ, (const uint16_t*)p.q + b * p.qs[0] +
                                h * p.qs[1] + q0 * p.qs[2],
                            p.qs[2], p.Sq - q0, D);
  cp_tile_swz<DS, PAD, 128>(sDO, (const uint16_t*)p.dout + b * p.dos[0] +
                                 h * p.dos[1] + q0 * p.dos[2],
                            p.dos[2], p.Sq - q0, D);
  cp_async_commit();
  const int nk = p.causal ? min(p.Skv, q0 + 64) : p.Skv;
  const int ntiles = (nk + 63) / 64;
  cp_tile_swz<DS, PAD, 128>(sKV, kg, p.ks[2], p.Skv, D);
  cp_tile_swz<DS, PAD, 128>(sKV + TB, vg, p.vs[2], p.Skv, D);
  cp_async_commit();
  const int rows[2] = {w0 + g, w0 + g + 8};
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = ((long long)b * p.H + h) * p.Sq + rows[r];
    lse2[r] = rows[r] < p.Sq ? p.lse_in[i] * kLog2e : 0.f;
    delta[r] = rows[r] < p.Sq ? p.delta[i] : 0.f;
  }
  const float sl2 = p.scale * kLog2e;
  float dq[DS / 8][4];
  zero_frags<DS / 8>(dq);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      const int k1 = (i + 1) * 64;
      uint8_t* st = sKV + ((i + 1) & 1) * 2 * TB;
      cp_tile_swz<DS, PAD, 128>(st, kg + k1 * p.ks[2], p.ks[2], p.Skv - k1,
                                D);
      cp_tile_swz<DS, PAD, 128>(st + TB, vg + k1 * p.vs[2], p.vs[2],
                                p.Skv - k1, D);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile i has landed; tile i + 1 may still fly
    fence_proxy_async();
    __syncthreads();
    const uint8_t* sK = sKV + (i & 1) * 2 * TB;
    const uint8_t* sV = sK + TB;
    const int k0 = i * 64;
    float s[8][4], dp[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk)
      wgmma_ss<64>(&s[0][0], desc_kmajor<DS>(sQ, kk), desc_kmajor<DS>(sK, kk),
                   kk);
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk)
      wgmma_ss<64>(&dp[0][0], desc_kmajor<DS>(sDO, kk),
                   desc_kmajor<DS>(sV, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    hold<32>(&s[0][0]);
    hold<32>(&dp[0][0]);
    const bool edge = (p.causal && k0 + 63 > w0) || k0 + 64 > p.Skv;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool off =
            edge && masked(p, rows[r], k0 + j * 8 + 2 * t + (e & 1));
        const float pe = off ? 0.f : ex2(s[j][e] * sl2 - lse2[r]);
        s[j][e] = pe * (dp[j][e] - delta[r]);
      }
    uint32_t da[4][4];
    pack_a<4>(da, s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DS>(&dq[0][0], da[kk], desc_mnmajor<DS>(sK, kk));
    wgmma_commit();
    wgmma_wait_all();
    hold<DS / 2>(&dq[0][0]);
    __syncthreads();  // every warp is done with stage i & 1
  }
  const float mul[2] = {p.scale, p.scale};
  store_rows<DS, PAD>((uint16_t*)p.out0 + b * p.o0s[0] + h * p.o0s[1],
                      p.o0s[2], dq, rows, mul, p.Sq, lane, D);
}

// K6: dk / dv of 64 keys of one kv head per block, one warpgroup, over one
// piece of the work: heads [hg hp, (hg + 1) hp) of the group and query
// tiles [c chunk, (c + 1) chunk), piece = hg n_chunks + c. The piece's
// (head, query tile) items go through a two-stage cp.async ring of Q, dO,
// lse and delta. s^T = k q^T and dp^T = v do^T read all four tiles from
// shared memory; dv += p^T do and dk += ds^T q take p^T / ds^T from
// registers. With one piece the block writes dk / dv; else it writes its
// fp32 partials (dk without the scale) to the scratch, and dkv_combine
// sums the pieces.
template <int DS, bool PAD>
__global__ void __launch_bounds__(128, DS <= 64 ? 3 : 2)
bwd_dkv_bf16(Params p) {
  constexpr int TB = Swz<DS>::kTileBytes;
  const int D = PAD ? p.D : DS;
  extern __shared__ __align__(16) uint8_t smem_w[];
  uint8_t* sK = smem_w + ((1024 - (smem_u32(smem_w) & 1023)) & 1023);
  uint8_t* sV = sK + TB;
  uint8_t* sQD = sV + TB;  // stage s: Q at 2 s TB, dO after it
  float* sStat = reinterpret_cast<float*>(sQD + 4 * TB);
  // one dimension: key tile slowest, so the heaviest causal tiles go first
  int lin = blockIdx.x;
  const int piece = lin % p.n_pieces;
  lin /= p.n_pieces;
  const int kvh = lin % p.KV;
  lin /= p.KV;
  const int b = lin % p.B, k0 = (lin / p.B) * 64;
  const int hg = piece / p.n_chunks, c = piece % p.n_chunks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = k0 + warp * 16;
  const int nqt = (p.Sq + kQueryTile - 1) / kQueryTile;
  // the first query that sees key k0 is k0 itself (causal)
  const int qt0 = max(c * p.chunk, p.causal ? k0 / kQueryTile : 0);
  const int nq = max(0, min((c + 1) * p.chunk, nqt) - qt0);
  const int items = p.hp * nq;
  cp_tile_swz<DS, PAD, 128>(sK, (const uint16_t*)p.k + b * p.ks[0] +
                                kvh * p.ks[1] + k0 * p.ks[2],
                            p.ks[2], p.Skv - k0, D);
  cp_tile_swz<DS, PAD, 128>(sV, (const uint16_t*)p.v + b * p.vs[0] +
                                kvh * p.vs[1] + k0 * p.vs[2],
                            p.vs[2], p.Skv - k0, D);
  cp_async_commit();
  // item i: head kvh G + hg hp + i / nq, query tile qt0 + i % nq
  auto load_item = [&](int i) {
    const int h = kvh * p.G + hg * p.hp + i / nq;
    const int q0 = (qt0 + i % nq) * kQueryTile;
    uint8_t* st = sQD + (i & 1) * 2 * TB;
    cp_tile_swz<DS, PAD, 128>(st, (const uint16_t*)p.q + b * p.qs[0] +
                                  h * p.qs[1] + q0 * p.qs[2],
                              p.qs[2], p.Sq - q0, D);
    cp_tile_swz<DS, PAD, 128>(st + TB, (const uint16_t*)p.dout +
                                       b * p.dos[0] + h * p.dos[1] +
                                       q0 * p.dos[2],
                              p.dos[2], p.Sq - q0, D);
    const long long row0 = ((long long)b * p.H + h) * p.Sq + q0;
    float* ss = sStat + (i & 1) * 2 * kQueryTile;
    cp_stats<128>(ss, p.lse_in + row0, p.Sq - q0);
    cp_stats<128>(ss + kQueryTile, p.delta + row0, p.Sq - q0);
  };
  if (items > 0) load_item(0);
  cp_async_commit();
  const int keys[2] = {w0 + g, w0 + g + 8};
  const float sl2 = p.scale * kLog2e;
  float dk[DS / 8][4], dv[DS / 8][4];
  zero_frags<DS / 8>(dk);
  zero_frags<DS / 8>(dv);
  for (int i = 0; i < items; ++i) {
    if (i + 1 < items) load_item(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint8_t* sQ = sQD + (i & 1) * 2 * TB;
    const uint8_t* sDO = sQ + TB;
    const float* sL = sStat + (i & 1) * 2 * kQueryTile;
    const float* sDelta = sL + kQueryTile;
    const int q0 = (qt0 + i % nq) * kQueryTile;
    // transposed scores: rows are the block's keys, columns queries
    float st[8][4], dpt[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk)
      wgmma_ss<64>(&st[0][0], desc_kmajor<DS>(sK, kk), desc_kmajor<DS>(sQ, kk),
                   kk);
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk)
      wgmma_ss<64>(&dpt[0][0], desc_kmajor<DS>(sV, kk),
                   desc_kmajor<DS>(sDO, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    hold<32>(&st[0][0]);
    hold<32>(&dpt[0][0]);
    const bool edge = (p.causal && q0 < w0 + 15) ||
                      q0 + kQueryTile > p.Sq || w0 + 16 > p.Skv;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(sL + col);
      const float2 d2 = *reinterpret_cast<const float2*>(sDelta + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool off = edge && masked(p, q0 + col + (e & 1), keys[e >> 1]);
        const float pe =
            off ? 0.f : ex2(st[j][e] * sl2 - (e & 1 ? l2.y : l2.x) * kLog2e);
        st[j][e] = pe;
        dpt[j][e] = pe * (dpt[j][e] - (e & 1 ? d2.y : d2.x));
      }
    }
    uint32_t pa[4][4], da[4][4];
    pack_a<4>(pa, st);
    pack_a<4>(da, dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DS>(&dv[0][0], pa[kk], desc_mnmajor<DS>(sDO, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DS>(&dk[0][0], da[kk], desc_mnmajor<DS>(sQ, kk));
    wgmma_commit();
    wgmma_wait_all();
    hold<DS / 2>(&dv[0][0]);
    hold<DS / 2>(&dk[0][0]);
    __syncthreads();
  }
  if (p.n_pieces == 1) {
    const float one[2] = {1.f, 1.f}, sc[2] = {p.scale, p.scale};
    store_rows<DS, PAD>((uint16_t*)p.out0 + b * p.o0s[0] + kvh * p.o0s[1],
                        p.o0s[2], dk, keys, sc, p.Skv, lane, D);
    store_rows<DS, PAD>((uint16_t*)p.out1 + b * p.o1s[0] + kvh * p.o1s[1],
                        p.o1s[2], dv, keys, one, p.Skv, lane, D);
    return;
  }
  // partials: scratch [piece][dk, dv][B][KV][Skv][D] fp32
  const long long per = (long long)p.B * p.KV * p.Skv * D;
  float* pk = p.scratch + 2 * piece * per +
              ((long long)b * p.KV + kvh) * p.Skv * D + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= p.Skv) continue;
    float* o = pk + (long long)keys[r] * D;
#pragma unroll
    for (int jd = 0; jd < DS / 8; ++jd) {
      if (PAD && jd * 8 >= D) continue;
      *reinterpret_cast<float2*>(o + jd * 8) =
          make_float2(dk[jd][2 * r], dk[jd][2 * r + 1]);
      *reinterpret_cast<float2*>(o + per + jd * 8) =
          make_float2(dv[jd][2 * r], dv[jd][2 * r + 1]);
    }
  }
}

// K6's second launch: dk = scale * sum of the pieces' dk partials, dv = the
// sum of their dv partials, in piece order (no atomics: the same bits on
// every run), cast to bf16 once. One thread per 8 elements of a key row.
template <int DS, bool PAD>
__global__ void __launch_bounds__(256)
dkv_combine(Params p) {
  const int D = PAD ? p.D : DS;
  const long long per = (long long)p.B * p.KV * p.Skv * D;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i * 8 >= per) return;
  const long long e = i * 8, row = e / D;
  const int d = (int)(e % D), key = (int)(row % p.Skv);
  const int kvh = (int)(row / p.Skv % p.KV), b = (int)(row / p.Skv / p.KV);
  float ak[8], av[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) ak[j] = av[j] = 0.f;
  for (int pc = 0; pc < p.n_pieces; ++pc) {
    const float* src = p.scratch + 2 * pc * per + e;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(src + 4 * h);
      const float4 y = *reinterpret_cast<const float4*>(src + per + 4 * h);
      ak[4 * h] += x.x; ak[4 * h + 1] += x.y; ak[4 * h + 2] += x.z;
      ak[4 * h + 3] += x.w;
      av[4 * h] += y.x; av[4 * h + 1] += y.y; av[4 * h + 2] += y.z;
      av[4 * h + 3] += y.w;
    }
  }
  uint4 ok, ov;
  uint32_t* pk = reinterpret_cast<uint32_t*>(&ok);
  uint32_t* pv = reinterpret_cast<uint32_t*>(&ov);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pk[j] = pack_bf16(ak[2 * j] * p.scale, ak[2 * j + 1] * p.scale);
    pv[j] = pack_bf16(av[2 * j], av[2 * j + 1]);
  }
  *reinterpret_cast<uint4*>((uint16_t*)p.out0 + b * p.o0s[0] +
                            kvh * p.o0s[1] + key * p.o0s[2] + d) = ok;
  *reinterpret_cast<uint4*>((uint16_t*)p.out1 + b * p.o1s[0] +
                            kvh * p.o1s[1] + key * p.o1s[2] + d) = ov;
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores: 64 rows per block, 4 threads per row; thread c of
// a row owns elements c, c + 4, c + 8, ... of the head dim
// ---------------------------------------------------------------------------

// kF32Tile rows of D floats into shared memory [row][DS]; zeros past
// `valid` and in columns D .. DS - 1.
template <int DS, bool PAD>
__device__ __forceinline__ void load_rows_f32(float* sm, const float* g,
                                              long long rs, int valid,
                                              float mul, int D) {
  for (int i = threadIdx.x; i < kF32Tile * DS; i += blockDim.x) {
    const int r = i / DS, c = i % DS;
    sm[i] = r < valid && (!PAD || c < D) ? g[r * rs + c] * mul : 0.f;
  }
}

template <int DS, bool PAD>
__global__ void __launch_bounds__(kF32Threads)
fwd_f32(Params p) {
  constexpr int E = DS / 4;
  const int D = PAD ? p.D : DS;
  __shared__ float sK[kF32Tile * DS], sV[kF32Tile * DS];
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.G;
  const int c = threadIdx.x & 3;
  const int q0 = qt * kTile, row = q0 + (threadIdx.x >> 2);
  const bool live = row < p.Sq;
  const float* qg = (const float*)p.q + b * p.qs[0] + h * p.qs[1] +
                    (long long)row * p.qs[2];
  const float* kg = (const float*)p.k + b * p.ks[0] + kvh * p.ks[1];
  const float* vg = (const float*)p.v + b * p.vs[0] + kvh * p.vs[1];
  float q[E], o[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    q[i] = live && (!PAD || c + 4 * i < D) ? qg[c + 4 * i] * p.scale : 0.f;
    o[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int nk = p.causal ? min(p.Skv, q0 + kTile) : p.Skv;
  for (int k0 = 0; k0 < nk; k0 += kF32Tile) {
    __syncthreads();
    load_rows_f32<DS, PAD>(sK, kg + k0 * p.ks[2], p.ks[2], p.Skv - k0, 1.f,
                           D);
    load_rows_f32<DS, PAD>(sV, vg + k0 * p.vs[2], p.vs[2], p.Skv - k0, 1.f,
                           D);
    __syncthreads();
    float s[kF32Tile];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) x += q[i] * sK[j * DS + c + 4 * i];
      x = quad_sum(x);
      if (masked(p, row, k0 + j)) x = kNegInf;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float safe = mx <= kMaskedBelow ? 0.f : mx;
    const float corr = m <= kMaskedBelow ? 0.f : expf(fminf(m - safe, 0.f));
    l *= corr;
#pragma unroll
    for (int i = 0; i < E; ++i) o[i] *= corr;
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) {
      const float pe = s[j] <= kMaskedBelow ? 0.f : expf(s[j] - safe);
      l += pe;
#pragma unroll
      for (int i = 0; i < E; ++i) o[i] += pe * sV[j * DS + c + 4 * i];
    }
    m = mx;
  }
  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-20f);
  float* og = (float*)p.out0 + b * p.o0s[0] + h * p.o0s[1] +
              (long long)row * p.o0s[2];
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (!PAD || c + 4 * i < D) og[c + 4 * i] = o[i] * inv;
  if (c == 0)
    p.lse[((long long)b * p.H + h) * p.Sq + row] =
        (m <= kMaskedBelow ? 0.f : m) + logf(fmaxf(l, 1e-20f));
}

template <int DS, bool PAD>
__global__ void __launch_bounds__(kF32Threads)
bwd_dq_f32(Params p) {
  constexpr int E = DS / 4;
  const int D = PAD ? p.D : DS;
  __shared__ float sK[kF32Tile * DS], sV[kF32Tile * DS];
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.G;
  const int c = threadIdx.x & 3;
  const int q0 = qt * kTile, row = q0 + (threadIdx.x >> 2);
  const bool live = row < p.Sq;
  const float* qg = (const float*)p.q + b * p.qs[0] + h * p.qs[1] +
                    (long long)row * p.qs[2];
  const float* dg = (const float*)p.dout + b * p.dos[0] + h * p.dos[1] +
                    (long long)row * p.dos[2];
  const float* kg = (const float*)p.k + b * p.ks[0] + kvh * p.ks[1];
  const float* vg = (const float*)p.v + b * p.vs[0] + kvh * p.vs[1];
  const long long ri = ((long long)b * p.H + h) * p.Sq + row;
  const float lse = live ? p.lse_in[ri] : 0.f;
  const float delta = live ? p.delta[ri] : 0.f;
  float q[E], d[E], dq[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const bool in = live && (!PAD || c + 4 * i < D);
    q[i] = in ? qg[c + 4 * i] * p.scale : 0.f;
    d[i] = in ? dg[c + 4 * i] : 0.f;
    dq[i] = 0.f;
  }
  const int nk = p.causal ? min(p.Skv, q0 + kTile) : p.Skv;
  for (int k0 = 0; k0 < nk; k0 += kF32Tile) {
    __syncthreads();
    load_rows_f32<DS, PAD>(sK, kg + k0 * p.ks[2], p.ks[2], p.Skv - k0, 1.f,
                           D);
    load_rows_f32<DS, PAD>(sV, vg + k0 * p.vs[2], p.vs[2], p.Skv - k0, 1.f,
                           D);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kF32Tile; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        s += q[i] * sK[j * DS + c + 4 * i];
        dp += d[i] * sV[j * DS + c + 4 * i];
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const float pe = masked(p, row, k0 + j) ? 0.f : expf(s - lse);
      const float ds = pe * (dp - delta);
#pragma unroll
      for (int i = 0; i < E; ++i) dq[i] += ds * sK[j * DS + c + 4 * i];
    }
  }
  if (!live) return;
  float* og = (float*)p.out0 + b * p.o0s[0] + h * p.o0s[1] +
              (long long)row * p.o0s[2];
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (!PAD || c + 4 * i < D) og[c + 4 * i] = dq[i] * p.scale;
}

template <int DS, bool PAD>
__global__ void __launch_bounds__(kF32Threads)
bwd_dkv_f32(Params p) {
  constexpr int E = DS / 4;
  const int D = PAD ? p.D : DS;
  __shared__ float sQ[kF32Tile * DS], sDO[kF32Tile * DS];
  __shared__ float sL[kF32Tile], sDelta[kF32Tile];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int c = threadIdx.x & 3;
  const int k0 = blockIdx.x * kTile, key = k0 + (threadIdx.x >> 2);
  const bool live = key < p.Skv;
  const float* kg = (const float*)p.k + b * p.ks[0] + kvh * p.ks[1] +
                    (long long)key * p.ks[2];
  const float* vg = (const float*)p.v + b * p.vs[0] + kvh * p.vs[1] +
                    (long long)key * p.vs[2];
  float kr[E], vr[E], dk[E], dv[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const bool in = live && (!PAD || c + 4 * i < D);
    kr[i] = in ? kg[c + 4 * i] : 0.f;
    vr[i] = in ? vg[c + 4 * i] : 0.f;
    dk[i] = dv[i] = 0.f;
  }
  const int qstart = p.causal ? k0 : 0;
  for (int gi = 0; gi < p.G; ++gi) {
    const int h = kvh * p.G + gi;
    const float* qg = (const float*)p.q + b * p.qs[0] + h * p.qs[1];
    const float* dg = (const float*)p.dout + b * p.dos[0] + h * p.dos[1];
    const long long row0 = ((long long)b * p.H + h) * p.Sq;
    for (int q0 = qstart; q0 < p.Sq; q0 += kF32Tile) {
      __syncthreads();
      // q pre-scaled, as the reference: dk then carries the scale
      load_rows_f32<DS, PAD>(sQ, qg + q0 * p.qs[2], p.qs[2], p.Sq - q0,
                             p.scale, D);
      load_rows_f32<DS, PAD>(sDO, dg + q0 * p.dos[2], p.dos[2], p.Sq - q0,
                             1.f, D);
      for (int i = threadIdx.x; i < kF32Tile; i += blockDim.x) {
        const bool in = q0 + i < p.Sq;
        sL[i] = in ? p.lse_in[row0 + q0 + i] : 0.f;
        sDelta[i] = in ? p.delta[row0 + q0 + i] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kF32Tile; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          s += kr[i] * sQ[j * DS + c + 4 * i];
          dp += vr[i] * sDO[j * DS + c + 4 * i];
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        const float pe = masked(p, q0 + j, key) ? 0.f : expf(s - sL[j]);
        const float ds = pe * (dp - sDelta[j]);
#pragma unroll
        for (int i = 0; i < E; ++i) {
          dv[i] += pe * sDO[j * DS + c + 4 * i];
          dk[i] += ds * sQ[j * DS + c + 4 * i];
        }
      }
    }
  }
  if (!live) return;
  float* kout = (float*)p.out0 + b * p.o0s[0] + kvh * p.o0s[1] +
                (long long)key * p.o0s[2];
  float* vout = (float*)p.out1 + b * p.o1s[0] + kvh * p.o1s[1] +
                (long long)key * p.o1s[2];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if (PAD && c + 4 * i >= D) continue;
    kout[c + 4 * i] = dk[i];
    vout[c + 4 * i] = dv[i];
  }
}

// ---------------------------------------------------------------------------
// head dims 129 .. 512: one simple design per kernel on the CUDA cores
// ---------------------------------------------------------------------------
//
// The same three functions above 128 (Gemma's 256): bwd_dq_wide and
// bwd_dkv_wide replace the Pallas kernels of
// horovod_tpu/ops/pallas_attention.py (_bwd_dq_kernel, _bwd_dkv_kernel)
// there for both dtypes, up to 256; fwd_wide replaces _fwd_kernel for
// fp32, up to 512 (bf16's forward is fwd_bf16 at DS 256). The wgmma
// designs above keep their accumulators in registers; K6's dk and dv (2 x
// 64 keys x 256 floats) would not fit in a warpgroup's. So these are
// written to be right first, on the CUDA cores, in fp32 whatever the
// stored type (bf16 is converted as it is staged; the softmax statistics,
// p and ds stay fp32):
//   * A block takes kWideRows = 16 query rows (K4, K5) or keys (K6) of one
//     (head, batch row); 256 threads. Its own rows are staged once as
//     fp32 rows of kWideLD = 257 floats (q pre-scaled; K4's q and k rows
//     kWideLD2 = 513 above 256), and the other side streams through in
//     tiles of kWideTile = 32 rows. The odd row stride puts one column of
//     16 distinct rows in 16 distinct banks.
//   * First product (scores, and dp in the backward): thread t computes
//     row t / 16 against tile rows t % 16 and t % 16 + 16, a loop over D;
//     the 16 threads of a row are a half warp, which reduces the online
//     softmax's max and sum with shuffles. p (or ds) goes to shared memory.
//   * Second product: thread d owns column d of every row of the block,
//     accumulated in registers (16 floats a thread, 32 in K6: dk and dv),
//     reading p / ds as broadcasts and the tile's column d. So K6 sums its
//     whole GQA group and all its queries in one block, in a fixed order:
//     no pieces, no scratch, no atomics. K4 above 256 splits its output's
//     columns in two parts over the grid, as fwd_bf16 does.
//   * Masks: every score tests the causal and ragged bounds (masked()); a
//     causal K4 / K5 block stops at its last row's diagonal and a K6 block
//     starts at its first key.
// What bounds it: the shared-memory reads of the products, roughly one
// 4-byte read per fma; the operation bound is the fp32 CUDA-core rate
// for fp32 and the bf16 tensor-core rate for bf16, far below what these
// kernels reach. A D that is not a multiple of 8 is zero-padded by the
// wrapper as for the narrow designs; columns past D are neither read nor
// written. Dynamic shared memory: 82-103 KB a block, two blocks an SM (K4
// above 256: 132 KB). Measured at Gemma-2B's attention (B 4, S 2048, H 8,
// KV 1, D 256, causal; chip_smoke.py phase 8 on an NVIDIA H100 80GB HBM3
// at 700 W): K5 / K6 in bf16 12.77 / 25.72 ms, K4 in fp32 11.17 ms (D
// 512: 55.60), 20-40x one SDPA call: right first, fast later.

constexpr int kWideD = 256;          // the widest head dim of K5 / K6, and
                                     // the columns of a K4 output part
constexpr int kWideLD = kWideD + 1;  // fp32 row stride in shared memory
constexpr int kWideLD2 = 2 * kWideD + 1;  // K4's q / k rows above 256
constexpr int kWideRows = 16;        // a block's own rows
constexpr int kWideTile = 32;        // rows of the other side a pass
constexpr int kWidePLD = kWideTile + 1;
constexpr int kWideThreads = 256;    // = kWideRows x 16 = kWideD

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// n rows of D elements at g (row stride rs) times mul, as fp32 rows of
// ld floats; rows past `valid` are zeros
template <typename T>
__device__ __forceinline__ void wide_rows(float* sm, const T* g, long long rs,
                                          int n, int valid, float mul, int D,
                                          int ld = kWideLD) {
  for (int i = threadIdx.x; i < n * D; i += kWideThreads) {
    const int r = i / D, c = i - r * D;
    sm[r * ld + c] = r < valid ? to_f32(g[r * rs + c]) * mul : 0.f;
  }
}

// dot products over D of row r of sa with rows j and j + 16 of sb (rows
// ld floats apart)
__device__ __forceinline__ void wide_dot2(const float* sa, const float* sb,
                                          int r, int j, int D, float& x0,
                                          float& x1, int ld = kWideLD) {
  const float* a = sa + r * ld;
  const float* b0 = sb + j * ld;
  const float* b1 = b0 + 16 * ld;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float x = a[d];
    s0 += x * b0[d];
    s1 += x * b1[d];
  }
  x0 = s0;
  x1 = s1;
}

// max / sum over the 16 lanes of a half warp
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// K4 in fp32 above 128 (bf16 runs fwd_bf16 at every head dim). Above 256
// the grid's z dimension also takes the output's 256-column parts, as
// fwd_bf16's does: q and k are staged whole (rows of kWideLD2 floats) for
// the scores, v only in the part's columns, and part 0 writes lse.
__global__ void __launch_bounds__(kWideThreads) fwd_wide(Params p) {
  using T = float;
  extern __shared__ float wsm[];
  const int D = p.D, np = (D + kWideD - 1) / kWideD;
  const int ld = np > 1 ? kWideLD2 : kWideLD;  // q and k rows
  float* sQ = wsm;                        // [kWideRows][ld], q * scale
  float* sK = sQ + kWideRows * ld;        // [kWideTile][ld]
  float* sV = sK + kWideTile * ld;        // [kWideTile][kWideLD]
  float* sP = sV + kWideTile * kWideLD;   // [kWideRows][kWidePLD]
  float* sA = sP + kWideRows * kWidePLD;  // this tile's rescale per row
  float* sL = sA + kWideRows;             // running sum per row
  const int h = blockIdx.y, b = blockIdx.z / np, kvh = h / p.G;
  const int c0 = blockIdx.z % np * kWideD, Dv = min(kWideD, D - c0);
  const int q0 = blockIdx.x * kWideRows;
  const int t = threadIdx.x, r = t >> 4, j = t & 15;
  const T* kg = (const T*)p.k + b * p.ks[0] + kvh * p.ks[1];
  const T* vg = (const T*)p.v + b * p.vs[0] + kvh * p.vs[1] + c0;
  wide_rows<T>(sQ,
               (const T*)p.q + b * p.qs[0] + h * p.qs[1] +
                   (long long)q0 * p.qs[2],
               p.qs[2], kWideRows, p.Sq - q0, p.scale, D, ld);
  if (t < kWideRows) sL[t] = 0.f;
  float m = kNegInf;  // row r's running max, the same in its 16 threads
  float acc[kWideRows];
#pragma unroll
  for (int i = 0; i < kWideRows; ++i) acc[i] = 0.f;
  const int nk = p.causal ? min(p.Skv, q0 + kWideRows) : p.Skv;
  for (int k0 = 0; k0 < nk; k0 += kWideTile) {
    __syncthreads();  // the previous tile is consumed
    wide_rows<T>(sK, kg + k0 * p.ks[2], p.ks[2], kWideTile, p.Skv - k0, 1.f,
                 D, ld);
    wide_rows<T>(sV, vg + k0 * p.vs[2], p.vs[2], kWideTile, p.Skv - k0, 1.f,
                 Dv);
    __syncthreads();
    float s0, s1;
    wide_dot2(sQ, sK, r, j, D, s0, s1, ld);
    if (masked(p, q0 + r, k0 + j)) s0 = kNegInf;
    if (masked(p, q0 + r, k0 + j + 16)) s1 = kNegInf;
    const float mx = half_max(fmaxf(m, fmaxf(s0, s1)));
    const float safe = mx <= kMaskedBelow ? 0.f : mx;
    const float corr = m <= kMaskedBelow ? 0.f : expf(fminf(m - safe, 0.f));
    const float p0 = s0 <= kMaskedBelow ? 0.f : expf(s0 - safe);
    const float p1 = s1 <= kMaskedBelow ? 0.f : expf(s1 - safe);
    sP[r * kWidePLD + j] = p0;
    sP[r * kWidePLD + j + 16] = p1;
    const float ps = half_sum(p0 + p1);
    if (j == 0) {
      sA[r] = corr;
      sL[r] = sL[r] * corr + ps;
    }
    m = mx;
    __syncthreads();
    if (t < Dv) {  // o[:, t] = o[:, t] * corr + p v[:, t]
#pragma unroll
      for (int i = 0; i < kWideRows; ++i) acc[i] *= sA[i];
      for (int jj = 0; jj < kWideTile; ++jj) {
        const float vv = sV[jj * kWideLD + t];
#pragma unroll
        for (int i = 0; i < kWideRows; ++i) acc[i] += sP[i * kWidePLD + jj] * vv;
      }
    }
  }
  __syncthreads();
  if (t < Dv) {
    T* og = (T*)p.out0 + b * p.o0s[0] + h * p.o0s[1] + c0;
#pragma unroll
    for (int i = 0; i < kWideRows; ++i)
      if (q0 + i < p.Sq)
        from_f32(acc[i] / fmaxf(sL[i], 1e-20f),
                 og + (long long)(q0 + i) * p.o0s[2] + t);
  }
  if (c0 == 0 && j == 0 && q0 + r < p.Sq)
    p.lse[((long long)b * p.H + h) * p.Sq + q0 + r] =
        (m <= kMaskedBelow ? 0.f : m) + logf(fmaxf(sL[r], 1e-20f));
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads) bwd_dq_wide(Params p) {
  extern __shared__ float wsm[];
  float* sQ = wsm;                         // q * scale
  float* sDO = sQ + kWideRows * kWideLD;
  float* sK = sDO + kWideRows * kWideLD;
  float* sV = sK + kWideTile * kWideLD;
  float* sDS = sV + kWideTile * kWideLD;   // [kWideRows][kWidePLD]
  float* sLse = sDS + kWideRows * kWidePLD;
  float* sDelta = sLse + kWideRows;
  const int D = p.D;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.G;
  const int q0 = blockIdx.x * kWideRows;
  const int t = threadIdx.x, r = t >> 4, j = t & 15;
  const T* kg = (const T*)p.k + b * p.ks[0] + kvh * p.ks[1];
  const T* vg = (const T*)p.v + b * p.vs[0] + kvh * p.vs[1];
  wide_rows<T>(sQ,
               (const T*)p.q + b * p.qs[0] + h * p.qs[1] +
                   (long long)q0 * p.qs[2],
               p.qs[2], kWideRows, p.Sq - q0, p.scale, D);
  wide_rows<T>(sDO,
               (const T*)p.dout + b * p.dos[0] + h * p.dos[1] +
                   (long long)q0 * p.dos[2],
               p.dos[2], kWideRows, p.Sq - q0, 1.f, D);
  if (t < kWideRows) {
    const long long ri = ((long long)b * p.H + h) * p.Sq + q0 + t;
    const bool live = q0 + t < p.Sq;
    sLse[t] = live ? p.lse_in[ri] : 0.f;
    sDelta[t] = live ? p.delta[ri] : 0.f;
  }
  float acc[kWideRows];
#pragma unroll
  for (int i = 0; i < kWideRows; ++i) acc[i] = 0.f;
  const int nk = p.causal ? min(p.Skv, q0 + kWideRows) : p.Skv;
  for (int k0 = 0; k0 < nk; k0 += kWideTile) {
    __syncthreads();
    wide_rows<T>(sK, kg + k0 * p.ks[2], p.ks[2], kWideTile, p.Skv - k0, 1.f,
                 D);
    wide_rows<T>(sV, vg + k0 * p.vs[2], p.vs[2], kWideTile, p.Skv - k0, 1.f,
                 D);
    __syncthreads();
    float s[2], dp[2];
    wide_dot2(sQ, sK, r, j, D, s[0], s[1]);
    wide_dot2(sDO, sV, r, j, D, dp[0], dp[1]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int jj = j + 16 * e;
      const float pe = masked(p, q0 + r, k0 + jj) ? 0.f : expf(s[e] - sLse[r]);
      sDS[r * kWidePLD + jj] = pe * (dp[e] - sDelta[r]);
    }
    __syncthreads();
    if (t < D) {  // dq[:, t] += ds k[:, t]
      for (int jj = 0; jj < kWideTile; ++jj) {
        const float kv = sK[jj * kWideLD + t];
#pragma unroll
        for (int i = 0; i < kWideRows; ++i) acc[i] += sDS[i * kWidePLD + jj] * kv;
      }
    }
  }
  if (t < D) {
    T* og = (T*)p.out0 + b * p.o0s[0] + h * p.o0s[1];
#pragma unroll
    for (int i = 0; i < kWideRows; ++i)
      if (q0 + i < p.Sq)
        from_f32(acc[i] * p.scale, og + (long long)(q0 + i) * p.o0s[2] + t);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads) bwd_dkv_wide(Params p) {
  extern __shared__ float wsm[];
  float* sK = wsm;                         // [kWideRows][kWideLD]: the keys
  float* sV = sK + kWideRows * kWideLD;
  float* sQ = sV + kWideRows * kWideLD;    // [kWideTile][kWideLD], q * scale
  float* sDO = sQ + kWideTile * kWideLD;
  float* sP = sDO + kWideTile * kWideLD;   // [kWideRows][kWidePLD]
  float* sDS = sP + kWideRows * kWidePLD;
  float* sLse = sDS + kWideRows * kWidePLD;  // [kWideTile]
  float* sDelta = sLse + kWideTile;
  const int D = p.D;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kWideRows;
  const int t = threadIdx.x, r = t >> 4, j = t & 15;
  wide_rows<T>(sK,
               (const T*)p.k + b * p.ks[0] + kvh * p.ks[1] +
                   (long long)k0 * p.ks[2],
               p.ks[2], kWideRows, p.Skv - k0, 1.f, D);
  wide_rows<T>(sV,
               (const T*)p.v + b * p.vs[0] + kvh * p.vs[1] +
                   (long long)k0 * p.vs[2],
               p.vs[2], kWideRows, p.Skv - k0, 1.f, D);
  float dk[kWideRows], dv[kWideRows];
#pragma unroll
  for (int i = 0; i < kWideRows; ++i) dk[i] = dv[i] = 0.f;
  const int qstart = p.causal ? k0 : 0;
  for (int gi = 0; gi < p.G; ++gi) {
    const int h = kvh * p.G + gi;
    const T* qg = (const T*)p.q + b * p.qs[0] + h * p.qs[1];
    const T* dg = (const T*)p.dout + b * p.dos[0] + h * p.dos[1];
    const long long row0 = ((long long)b * p.H + h) * p.Sq;
    for (int q0 = qstart; q0 < p.Sq; q0 += kWideTile) {
      __syncthreads();
      // q pre-scaled, as the reference: dk then carries the scale
      wide_rows<T>(sQ, qg + q0 * p.qs[2], p.qs[2], kWideTile, p.Sq - q0,
                   p.scale, D);
      wide_rows<T>(sDO, dg + q0 * p.dos[2], p.dos[2], kWideTile, p.Sq - q0,
                   1.f, D);
      if (t < kWideTile) {
        const bool in = q0 + t < p.Sq;
        sLse[t] = in ? p.lse_in[row0 + q0 + t] : 0.f;
        sDelta[t] = in ? p.delta[row0 + q0 + t] : 0.f;
      }
      __syncthreads();
      float s[2], dp[2];
      wide_dot2(sK, sQ, r, j, D, s[0], s[1]);
      wide_dot2(sV, sDO, r, j, D, dp[0], dp[1]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = j + 16 * e;
        const float pe =
            masked(p, q0 + jj, k0 + r) ? 0.f : expf(s[e] - sLse[jj]);
        sP[r * kWidePLD + jj] = pe;
        sDS[r * kWidePLD + jj] = pe * (dp[e] - sDelta[jj]);
      }
      __syncthreads();
      if (t < D) {  // dv[:, t] += p^T do[:, t], dk[:, t] += ds^T q[:, t]
        for (int jj = 0; jj < kWideTile; ++jj) {
          const float dov = sDO[jj * kWideLD + t];
          const float qv = sQ[jj * kWideLD + t];
#pragma unroll
          for (int i = 0; i < kWideRows; ++i) {
            dv[i] += sP[i * kWidePLD + jj] * dov;
            dk[i] += sDS[i * kWidePLD + jj] * qv;
          }
        }
      }
    }
  }
  if (t < D) {
    T* kout = (T*)p.out0 + b * p.o0s[0] + kvh * p.o0s[1];
    T* vout = (T*)p.out1 + b * p.o1s[0] + kvh * p.o1s[1];
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) {
      if (k0 + i >= p.Skv) continue;
      from_f32(dk[i], kout + (long long)(k0 + i) * p.o0s[2] + t);
      from_f32(dv[i], vout + (long long)(k0 + i) * p.o1s[2] + t);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// Dynamic shared memory of one block of a D > 128 kernel on the CUDA
// cores: K4 in fp32 (q and k rows of kWideLD2 floats above 256), K5 / K6
// in either dtype.
size_t wide_smem_bytes(Kind kind, int D) {
  const size_t own = kWideRows * kWideLD, tile = kWideTile * kWideLD,
               pl = kWideRows * kWidePLD;
  if (kind == kFwd) {
    const size_t ld = D > kWideD ? kWideLD2 : kWideLD;
    return sizeof(float) * ((kWideRows + kWideTile) * ld + tile + pl +
                            2 * kWideRows);
  }
  if (kind == kDq)
    return sizeof(float) * (2 * own + 2 * tile + pl + 2 * kWideRows);
  return sizeof(float) * (2 * own + 2 * tile + 2 * pl + 2 * kWideTile);
}

// Dynamic shared memory of one block of a bf16 kernel, 1024-byte aligned:
// K4 its Q tiles and the stages of its ring (fwd_smem; D 136 .. 512 at
// DS 256); K5 / K6 six swizzled 64-row tiles (Q and dO or K and V, and a
// 2-stage ring of two), K6's ring with its lse and delta, and above 128
// their CUDA-core designs'.
size_t smem_bytes(Kind kind, int D) {
  if (kind == kFwd)
    return fwd_smem(stored_dim(D), D > kWideD ? 2 : 1);
  if (D > 128) return wide_smem_bytes(kind, D);
  const int DS = stored_dim(D);
  return 6 * 64 * DS * sizeof(uint16_t) + 1024 +
         (kind == kDkv ? 4 * kQueryTile * sizeof(float) : 0);
}

cudaError_t launch_fn(void (*fn)(Params), dim3 grid, int threads,
                      size_t smem, cudaStream_t stream, const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fn<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// D > 128 on the CUDA cores: grid (row tiles, heads, batch x output parts)
// for K4 in fp32, (row tiles, heads, batch) for K5, (key tiles, kv heads,
// batch) for K6; one launch each, no pieces.
template <typename T>
cudaError_t launch_wide(Kind kind, const Params& p, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(kind, p.D);
  const unsigned rows = (p.Sq + kWideRows - 1) / kWideRows;
  if (kind == kDkv)
    return launch_fn(bwd_dkv_wide<T>,
                     dim3((p.Skv + kWideRows - 1) / kWideRows, p.KV, p.B),
                     kWideThreads, smem, stream, p);
  if (kind == kDq)
    return launch_fn(bwd_dq_wide<T>, dim3(rows, p.H, p.B), kWideThreads,
                     smem, stream, p);
  return launch_fn(fwd_wide, dim3(rows, p.H, p.B * ((p.D + kWideD - 1) /
                                                    kWideD)),
                   kWideThreads, smem, stream, p);
}

// K4 in bf16: one dimension, heaviest causal tiles first (query tile,
// batch, head), times the output parts above 256
template <int DS, bool PAD, int NC>
cudaError_t launch_fwd_bf16(const Params& p, cudaStream_t stream) {
  constexpr int WG = fwd_wgs(DS, NC);
  const int qtiles = (p.Sq + 64 * WG - 1) / (64 * WG);
  return launch_fn(fwd_bf16<DS, PAD, NC>, dim3(qtiles * p.B * p.H, NC),
                   128 * WG, fwd_smem(DS, NC), stream, p);
}

template <int DS, bool PAD>
cudaError_t launch_d(Kind kind, const Params& p, int dtype,
                     cudaStream_t stream) {
  const int qtiles = (p.Sq + kTile - 1) / kTile;
  const int ktiles = (p.Skv + kTile - 1) / kTile;
  if (dtype == 0) {
    const dim3 grid(kind == kDkv ? ktiles : qtiles,
                    kind == kDkv ? p.KV : p.H, p.B);
    void (*fn)(Params) = kind == kFwd  ? fwd_f32<DS, PAD>
                         : kind == kDq ? bwd_dq_f32<DS, PAD>
                                       : bwd_dkv_f32<DS, PAD>;
    fn<<<grid, kF32Threads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  if (kind == kFwd) return launch_fwd_bf16<DS, PAD, 1>(p, stream);
  const size_t smem = smem_bytes(kind, DS);
  // one dimension, heaviest causal tiles first: (query tile, batch, head)
  // for K5, (key tile, batch, kv head, piece) for K6
  if (kind == kDq)
    return launch_fn(bwd_dq_bf16<DS, PAD>, dim3(qtiles * p.B * p.H), 128,
                     smem, stream, p);
  cudaError_t err =
      launch_fn(bwd_dkv_bf16<DS, PAD>,
                dim3(ktiles * p.B * p.KV * p.n_pieces), 128, smem, stream, p);
  if (err != cudaSuccess || p.n_pieces == 1) return err;
  const long long rows8 = (long long)p.B * p.KV * p.Skv * (p.D / 8);
  return launch_fn(dkv_combine<DS, PAD>, dim3((unsigned)((rows8 + 255) / 256)),
                   256, 0, stream, p);
}

// dims: B, H, KV, Sq, Skv, D, then (batch, head, row) strides in elements of
// q, k, v, do, out0, out1 (3 each; unused ones ignored), then K6's split
// in bf16 at D <= 128: heads per piece, query tiles per chunk, chunks.
int launch(Kind kind, const void* q, const void* k, const void* v,
           const void* dout, const float* lse_in, const float* delta,
           void* out0, void* out1, float* lse, float* scratch,
           const long long* dims, float scale, int causal, int dtype,
           void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = lse_in;
  p.delta = delta;
  p.out0 = out0;
  p.out1 = out1;
  p.lse = lse;
  p.scratch = scratch;
  p.B = (int)dims[0];
  p.H = (int)dims[1];
  p.KV = (int)dims[2];
  p.Sq = (int)dims[3];
  p.Skv = (int)dims[4];
  const int D = (int)dims[5];
  p.D = D;
  // the forward takes D up to 512 (two output parts), K5 / K6 up to 256
  if (D < 8 || D > (kind == kFwd ? 2 * kWideD : kWideD) || D % 8 ||
      p.KV <= 0 || p.H % p.KV || p.B <= 0 || p.Sq <= 0 || p.Skv <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  p.G = p.H / p.KV;
  long long* dst[6] = {p.qs, p.ks, p.vs, p.dos, p.o0s, p.o1s};
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = dims[6 + 3 * i + j];
  p.scale = scale;
  p.causal = causal;
  p.hp = (int)dims[24];
  p.chunk = (int)dims[25];
  p.n_chunks = (int)dims[26];
  p.n_pieces = p.hp > 0 ? p.G / p.hp * p.n_chunks : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (D > 128 && dtype == 1 && kind == kFwd) {
    // K4 in bf16 at DS 256: one chunk up to 256, two above
    const bool pad = D % kWideD != 0;
    if (D > kWideD)
      return (int)(pad ? launch_fwd_bf16<256, true, 2>(p, s)
                       : launch_fwd_bf16<256, false, 2>(p, s));
    return (int)(pad ? launch_fwd_bf16<256, true, 1>(p, s)
                     : launch_fwd_bf16<256, false, 1>(p, s));
  }
  if (D > 128)
    return (int)(dtype == 0 ? launch_wide<float>(kind, p, s)
                            : launch_wide<__nv_bfloat16>(kind, p, s));
  if (dtype == 1 && kind == kDkv &&
      (p.hp <= 0 || p.G % p.hp || p.chunk <= 0 || p.n_chunks <= 0 ||
       (p.n_pieces > 1 && scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool pad = D != stored_dim(D);
  switch (stored_dim(D)) {
    case 16:
      return (int)(pad ? launch_d<16, true>(kind, p, dtype, s)
                       : launch_d<16, false>(kind, p, dtype, s));
    case 32:
      return (int)(pad ? launch_d<32, true>(kind, p, dtype, s)
                       : launch_d<32, false>(kind, p, dtype, s));
    case 64:
      return (int)(pad ? launch_d<64, true>(kind, p, dtype, s)
                       : launch_d<64, false>(kind, p, dtype, s));
    default:
      return (int)(pad ? launch_d<128, true>(kind, p, dtype, s)
                       : launch_d<128, false>(kind, p, dtype, s));
  }
}

}  // namespace

extern "C" {

// o and lse [B, H, Sq] (fp32, contiguous) from q, k, v.
int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, const long long* dims, float scale, int causal,
                  int dtype, void* stream) {
  return launch(kFwd, q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse,
                nullptr, dims, scale, causal, dtype, stream);
}

// dq from q, k, v, do and the forward's lse and delta [B, H, Sq] (fp32).
int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, const long long* dims, float scale,
                     int causal, int dtype, void* stream) {
  return launch(kDq, q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                nullptr, dims, scale, causal, dtype, stream);
}

// dk and dv from q, k, v, do, lse and delta; in bf16 with more than one
// piece, `scratch` holds 2 x pieces x B x KV x Skv x D floats of partials.
int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, float* scratch,
                      const long long* dims, float scale, int causal,
                      int dtype, void* stream) {
  return launch(kDkv, q, k, v, dout, lse, delta, dk, dv, nullptr, scratch,
                dims, scale, causal, dtype, stream);
}

// Bytes of dynamic shared memory a bf16 kernel's block takes (kind 0 K4,
// 1 K5, 2 K6) at head dim D.
long long hvd_flash_smem_bytes(int kind, int D) {
  return (long long)smem_bytes((Kind)kind, D);
}

}  // extern "C"
