// Paged attention over a block-table KV pool, written by hand for Hopper
// (sm_90a).
//
// Replaces horovod_tpu/ops/pallas_paged.py:_paged_attn_kernel (the Pallas
// kernel behind paged_attention_fused). Same function: for each batch row
// b and kv head h, the R = T*G queries of that row (T positions x G grouped
// query heads, row r = t*G + g) attend over the row's cached keys,
// gathered through its block table, with key j valid for query position t
// iff j <= pos[b] + t. Scores, softmax and the value sum are fp32 whatever
// the storage type; the output is written in q's type. Keys in unassigned
// (-1) pages are never read and count as invalid; a row that sees no valid
// key writes zeros.
//
// Two designs, chosen by the wrapper from host-known shapes (R against
// kMaxDecodeRows, kMaxDecodeRowsWide above head dim 128), never from the
// positions:
//
// Decode (R <= 16: Llama decode has 8 rows per (b, kv head), GPT 1; in
// bf16 above head dim 128, R <= 64 in tiles of 16).
//   Bound by bytes: 4*G*D flops per cached key on 4*D bytes of bf16 K/V,
//   about 2*G flops per byte against the H100's ~295 flops/byte ridge, so
//   the floor is the KV bytes over 3.35 TB/s. What the design does:
//   * Split-KV (flash-decoding): grid (n_split, KV, B). Each block owns a
//     contiguous range of whole pages of its row, so B*KV*n_split blocks
//     stream the cache even at B 1; n_split comes from the table's length
//     and the SM count (ops/paged.py:split_plan).
//   * A split whose range starts past pos + T - 1, or whose pages are all
//     -1, writes an empty partial (m = -inf, l = 0, o = 0) and exits
//     without touching the pool.
//   * 64-key tiles go through a two-stage ring in shared memory with
//     cp.async 16-byte copies in the stored type; the next tile loads
//     while the current one is scored. Keys past the range's last valid
//     position and keys of -1 pages are zero-filled (src-size 0), never
//     read: a stale pool byte may be a NaN pattern, and 0 * NaN poisons
//     the value sum.
//   * bf16: the products on the tensor cores (mma.sync m16n8k16, fp32
//     accumulation). The R rows, padded to 16, are the A operand; each of
//     4 warps takes 16 keys of every tile with an online softmax of its
//     own, and the warps merge in warp order at the end. On the CUDA cores
//     the same work costs ~1,600 instructions a thread a tile (8 rows x 64
//     keys x D, plus the bf16 conversions), several times the time of the
//     bytes.
//   * fp32: the math on the CUDA cores (one thread per (key, half of the
//     rows) for the scores, an online softmax per row, one thread per
//     (row, 4 dims) for P.V); it serves the fp32 parity runs.
//   * Each block writes its partial (m, l, unnormalised o[D]) in fp32 to a
//     workspace.
//   * A second launch merges the partials of each (b, t, h), one block per
//     output row: four warps each sum a quarter of the splits in split
//     order, and the quarters are added in warp order. No atomics: the
//     output is the same bit for bit on every run.
//
// Prefill (R > 16), bf16. Near the ridge at the bucket sizes: each staged
//   key serves up to 64 query rows (B 8, T 512 from position 0: 8.6 GFLOP
//   on 38 MB, ~230 flops a byte against ~295). What the design does:
//   * Grid (query tiles, KV, B); a query tile is 64 rows of the r = t*G + g
//     order (8 positions x 8 heads at G 8), so every key tile serves the
//     whole tile and the causal limits inside a tile differ by at most
//     64/G positions.
//   * 64-key tiles gathered through the block table with cp.async into a
//     two-stage ring (zero-filled past the tile's last limit and for -1
//     pages, as above); key tiles wholly past the tile's last limit are
//     never visited.
//   * Q.K^T and P.V on the tensor cores with mma.sync m16n8k16 (bf16
//     products, fp32 accumulation), FlashAttention-2's warp layout: each
//     of 4 warps owns 16 query rows; the score accumulator is repacked in
//     registers as the A operand of P.V, so scores never leave the SM.
//     Only tiles that cross a limit or hold an unloaded key are masked.
// Prefill, fp32: the CUDA-core design of the first port (32 keys staged
//   per pass as fp32, one lane per key); it serves the fp32 parity runs,
//   not the bf16 serving path.
//
// Head dims: every multiple of 8 from 8 to 512. In bf16 the two designs
// take them all: above 128 at a stored width DS of 256 (the notes at
// decode_bf16_kernel and prefill_bf16_kernel), above 256 with the output's
// columns in two parts over the grid. In fp32 the multiples of 8 above 128
// run on one simple design for every T (the section "head dims 129 .. 512,
// fp32" below, entry hvd_paged_attention_wide). Up to 128, each kernel is
// built for a stored width DS of 16, 32, 64 or 128 (stored_dim: the
// smallest that holds D) and takes D at run time. At D < DS the Q, K and V tiles' columns D ..
// DS - 1 are zero-filled by the copy (src-size 0), the products and the
// CUDA-core loops run over DS columns (the zero ones add nothing) and only
// the first D columns of an output or a partial are written; the pools,
// q, out and the decode workspace keep the true D. At D == DS the padding
// is a compile-time branch (the PAD template argument). The bf16 products
// have a depth of 16 (m16n8k16), so D 8 runs on D-16 tiles. A padded D
// pays for DS. Any other D up to 128 reaches the kernels zero-padded to
// the next multiple of 8 by the wrapper (a copy of q and both pools, in
// ops/paged.py), with d_scale = the true D for the scores' scale.
//
// Not done yet (later work): wgmma and TMA, ldmatrix fragment loads up to
// DS 128, persistent blocks. The decode kernel spends most of its time on its
// loads: the pool's [slot][kv head][D] layout gives each block 128-byte
// runs, and a block that took every kv head of its keys would read
// 512-byte runs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
// Binding: ctypes, see horovod_tpu_torch/ops/paged.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // 4 warps, every kernel here
constexpr int kWarps = kThreads / 32;
constexpr int kKeyTile = 64;        // keys staged per pass (decode, prefill)
constexpr int kStages = 2;          // the cp.async ring
constexpr int kMaxDecodeRows = 16;  // rows T*G of one (b, kv head), decode
constexpr int kMaxDecodeRowsWide = 64;  // the same at DS 256: 16-row tiles
constexpr int kQueryTile = 64;      // rows of a bf16 prefill block
constexpr float kNegInf = -1e30f;   // prefill's mask value
constexpr float kMaskedBelow = kNegInf / 2;

// The stored width DS of head dim D (a multiple of 8): the smallest of 16,
// 32, 64, 128 and 256 that holds it, 256 above that (the bf16 designs'
// column parts). Kernel instances are built for DS and take D at run time;
// at D < DS (PAD) the tiles' columns D .. DS - 1 are zero-filled and only
// columns < D are written.
__host__ __device__ constexpr int stored_dim(int D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}
// cp.async ring stages of the bf16 designs: two up to DS 128; one at DS
// 256, where a second stage would halve the blocks an SM holds (the
// blocks resident beside each other overlap one's copies with another's
// products instead)
__host__ __device__ constexpr int bf16_stages(int DS) {
  return DS <= 128 ? kStages : 1;
}

// ---------------------------------------------------------------------------
// loads and stores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// 16 bytes as 4 floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Keys [c0, c0 + kKeyTile) of kv head kvh, gathered through the row's
// block table `tbl`, into sK (row stride LDK, DPK >= D columns) and sV
// (row stride LDV, DPV columns from column cv0 of the pool's rows; the
// same columns as sK unless the bf16 designs split their output above
// 256). A key is loaded iff it lies below k_end and its page is assigned;
// any other row, and columns at or past D, are zero-filled and never read
// from the pool. ok[jj] records which keys were loaded. Returns whether
// this thread left any of its rows unloaded.
template <typename T, int DPK, int LDK, int DPV = DPK, int LDV = LDK>
__device__ __forceinline__ bool load_kv_tile(T* sK, T* sV, int* ok,
                                             const T* pool_k,
                                             const T* pool_v, const int* tbl,
                                             int c0, int k_end, int BS,
                                             int KV, int kvh, int D,
                                             int cv0 = 0) {
  constexpr int VN = 16 / sizeof(T);
  constexpr int kVecs = DPK / VN;
  bool unloaded = false;
  if constexpr (DPK >= 256) {
    // rows of 32 chunks or more (DS 256): each pass of a warp copies part
    // of one row, so lane l works out the pool offset of the row of the
    // warp's l-th pass once (one table read, one division by BS) and each
    // pass takes its row's by a shuffle
    constexpr int kVecsV = DPV / VN;
    const int lane = threadIdx.x & 31, base = threadIdx.x & ~31;
    auto row_offset = [&](int n, int vecs) -> long long {
      const int j = c0 + (base + kThreads * n) / vecs;
      const int blk = j < k_end ? tbl[j / BS] : -1;
      return blk < 0 ? -1
                     : (((long long)blk * BS + j % BS) * KV + kvh) * D;
    };
    constexpr int NK = kKeyTile * kVecs / kThreads;
    static_assert(NK <= 32, "a lane per pass");
    const long long mine = lane < NK ? row_offset(lane, kVecs) : -1;
#pragma unroll 4
    for (int n = 0; n < NK; ++n) {
      const long long off = __shfl_sync(0xffffffffu, mine, n);
      const int i = threadIdx.x + kThreads * n;
      const int jj = i / kVecs, c = (i % kVecs) * VN;
      const bool key = off >= 0, in = key && c < D;
      cp_async16(sK + jj * LDK + c, pool_k + (in ? off + c : 0), in);
      if (DPK == DPV)
        cp_async16(sV + jj * LDV + c, pool_v + (in ? off + c : 0), in);
      if (c == 0) ok[jj] = key;
      unloaded |= !key;
    }
    if (DPK != DPV) {
      constexpr int NV = kKeyTile * kVecsV / kThreads;
      static_assert(NV <= 32 && kVecsV % 32 == 0, "a lane per pass");
      const long long minev = lane < NV ? row_offset(lane, kVecsV) : -1;
#pragma unroll 4
      for (int n = 0; n < NV; ++n) {
        const long long off = __shfl_sync(0xffffffffu, minev, n);
        const int i = threadIdx.x + kThreads * n;
        const int jj = i / kVecsV, c = (i % kVecsV) * VN;
        const bool in = off >= 0 && cv0 + c < D;
        cp_async16(sV + jj * LDV + c, pool_v + (in ? off + cv0 + c : 0), in);
      }
    }
  } else {
    static_assert(DPK == DPV, "one width up to DS 128");
    for (int i = threadIdx.x; i < kKeyTile * kVecs; i += kThreads) {
      const int jj = i / kVecs, c = (i % kVecs) * VN;
      const int j = c0 + jj;
      const int blk = j < k_end ? tbl[j / BS] : -1;
      const bool key = blk >= 0, in = key && c < D;
      const size_t off =
          in ? (((size_t)blk * BS + j % BS) * KV + kvh) * D + c : 0;
      cp_async16(sK + jj * LDK + c, pool_k + off, in);
      cp_async16(sV + jj * LDV + c, pool_v + off, in);
      if (c == 0) ok[jj] = key;
      unloaded |= !key;
    }
  }
  return unloaded;
}

// NR rows of a query tile, each DPQ >= 256 columns (DS 256; row stride LDQ
// in shared memory): tile row rl is query row r0 + rl (r = t * G + g) of
// batch row b and kv head kvh, zero-filled at or past row rmax and column
// D. A warp's pass copies part of one row, so lane l works out the global
// offset of its warp's l-th pass once and the passes take it by shuffle.
template <int NR, int DPQ, int LDQ>
__device__ __forceinline__ void load_q_rows(uint16_t* sQ, const uint16_t* q,
                                            int r0, int rmax, int b, int n_t,
                                            int H, int G, int kvh, int D) {
  constexpr int kVecs = DPQ / 8, NP = NR * kVecs / kThreads;
  static_assert(kVecs % 32 == 0 && NP <= 32, "a lane per pass");
  const int lane = threadIdx.x & 31, base = threadIdx.x & ~31;
  long long mine = -1;
  if (lane < NP) {
    const int r = r0 + (base + kThreads * lane) / kVecs;
    if (r < rmax)
      mine = (((long long)b * n_t + r / G) * H + kvh * G + r % G) * D;
  }
#pragma unroll 4
  for (int n = 0; n < NP; ++n) {
    const long long off = __shfl_sync(0xffffffffu, mine, n);
    const int i = threadIdx.x + kThreads * n;
    const int rl = i / kVecs, c = (i % kVecs) * 8;
    const bool in = off >= 0 && c < D;
    cp_async16(sQ + rl * LDQ + c, q + (in ? off + c : 0), in);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16 (the helpers of flash_attention.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_u16(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// Fragments of mma.m16n8k16 (g = lane / 4, t = lane % 4).
// A: 16 x 16 at (r0, k0) of a row-major [row][k] tile.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t* a, const uint16_t* sm,
                                       int r0, int k0, int lane) {
  const uint16_t* p = sm + (r0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * LD);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * LD + 8);
}

// B: 16 (k) x 8 (n) at (k0, n0) of a tile stored [n][k].
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t* b, const uint16_t* sm,
                                          int n0, int k0, int lane) {
  const uint16_t* p = sm + (n0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  b[0] = ld_u32(p);
  b[1] = ld_u32(p + 8);
}

// B: 16 (k) x 8 (n) at (k0, n0) of a tile stored [k][n].
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t* b, const uint16_t* sm,
                                          int k0, int n0, int lane) {
  const uint16_t* p = sm + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  b[0] = pack_u16(p[0], p[LD]);
  b[1] = pack_u16(p[8 * LD], p[9 * LD]);
}

// The same fragments by ldmatrix (the designs at DS 256, where a tile row
// is 256 columns): four 8 x 8 matrices a warp-wide instruction, each lane
// giving one row's address (16-byte aligned rows; a row stride of 16
// bytes mod 128 puts 8 rows in 8 distinct bank groups).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A: frag_a's fragment, one ldmatrix.x4
template <int LD>
__device__ __forceinline__ void frag_a_ldsm(uint32_t* a, const uint16_t* sm,
                                            int r0, int k0, int lane) {
  ldsm_x4(a, sm + (r0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}

// B of two n blocks n0 and n0 + 8 (b[0], b[1]) at k step k0 of a tile
// stored [n][k]: frag_b_nk's fragments, one ldmatrix.x4
template <int LD>
__device__ __forceinline__ void frag_b_nk2(uint32_t (*b)[2],
                                           const uint16_t* sm, int n0,
                                           int k0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4(&b[0][0],
          sm + (n0 + (mi >> 1) * 8 + (lane & 7)) * LD + k0 + (mi & 1) * 8);
}

// B of two n blocks n0 and n0 + 8 at k step k0 of a tile stored [k][n]:
// frag_b_kn's fragments, one ldmatrix.x4.trans
template <int LD>
__device__ __forceinline__ void frag_b_kn2(uint32_t (*b)[2],
                                           const uint16_t* sm, int k0,
                                           int n0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4_t(&b[0][0],
            sm + (k0 + (mi & 1) * 8 + (lane & 7)) * LD + n0 + (mi >> 1) * 8);
}

// acc[j] (16 x 8, j over the tile's 8 key columns) += Q(16 x D at rows r0
// of sq) K^T, K the [key][D] tile sk. At D >= 256 the fragments come by
// ldmatrix.
template <int D, int LD>
__device__ __forceinline__ void mma_qk(float (*acc)[4], const uint16_t* sq,
                                       const uint16_t* sk, int r0,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    if constexpr (D >= 256) {
      frag_a_ldsm<LD>(a, sq, r0, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; j += 2) {
        uint32_t b[2][2];
        frag_b_nk2<LD>(b, sk, j * 8, kk * 16, lane);
        mma_bf16(acc[j], a, b[0]);
        mma_bf16(acc[j + 1], a, b[1]);
      }
    } else {
      frag_a<LD>(a, sq, r0, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        uint32_t b[2];
        frag_b_nk<LD>(b, sk, j * 8, kk * 16, lane);
        mma_bf16(acc[j], a, b);
      }
    }
  }
}

// acc[jd] (16 x 8, jd over D / 8) += P V, P (16 x 64) in the score
// fragments s[8][4] repacked as bf16 A operands, V the [key][D] tile sv.
template <int D, int LD>
__device__ __forceinline__ void mma_pv(float (*acc)[4], const float (*s)[4],
                                       const uint16_t* sv, int lane) {
#pragma unroll
  for (int kk = 0; kk < kKeyTile / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    if constexpr (D >= 256) {
#pragma unroll
      for (int jd = 0; jd < D / 8; jd += 2) {
        uint32_t b[2][2];
        frag_b_kn2<LD>(b, sv, kk * 16, jd * 8, lane);
        mma_bf16(acc[jd], a, b[0]);
        mma_bf16(acc[jd + 1], a, b[1]);
      }
    } else {
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        uint32_t b[2];
        frag_b_kn<LD>(b, sv, kk * 16, jd * 8, lane);
        mma_bf16(acc[jd], a, b);
      }
    }
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

// ---------------------------------------------------------------------------
// decode: split-KV partials, then the combine
// ---------------------------------------------------------------------------

// The key range [k_begin, k_end) of one decode block, k_end capped at the
// first key no query row sees (pos + n_t). A range that holds no valid key
// (it starts past that key, or its pages are all -1) writes an empty
// partial (m = -inf, l = 0, o = 0 in its Dv columns from cv0; m and l by
// the block of columns 0) without reading the pool and returns -1. Every
// thread of the block calls it (it holds a barrier).
__device__ __forceinline__ int decode_range(const int* tbl, int pos, int n_t,
                                            int k_begin, int keys_per_split,
                                            int BS, int nblk, int R,
                                            size_t part, float* part_o,
                                            float* part_ml, int D,
                                            int cv0 = 0, int Dv = -1) {
  const int k_stop = min(k_begin + keys_per_split, nblk * BS);
  const int k_end = min(k_stop, pos + n_t);
  bool any = false;
  for (int p = threadIdx.x; p * BS < k_stop - k_begin; p += kThreads) {
    const int blk = tbl[k_begin / BS + p];  // loads beside the position's
    any |= blk >= 0 && k_begin + p * BS < k_end;
  }
  if (__syncthreads_or(any)) return k_end;
  if (Dv < 0) Dv = D;
  for (int i = threadIdx.x; i < R * Dv; i += kThreads)
    part_o[(part + i / Dv) * D + cv0 + i % Dv] = 0.f;
  for (int r = threadIdx.x; r < R && cv0 == 0; r += kThreads) {
    part_ml[2 * (part + r)] = -INFINITY;
    part_ml[2 * (part + r) + 1] = 0.f;
  }
  return -1;
}

template <int DS>
struct DecodeF32Smem {
  static constexpr int LD = DS + 4;         // one 16-byte pad a row
  static constexpr int SLD = kKeyTile + 1;  // score rows, padded
  static constexpr size_t kv = sizeof(float) * kStages * kKeyTile * LD;
  static constexpr size_t bytes =
      2 * kv + sizeof(float) * kMaxDecodeRows * LD +
      sizeof(float) * (kMaxDecodeRows * SLD + 3 * kMaxDecodeRows) +
      sizeof(int) * kStages * kKeyTile;
};

// fp32 decode on the CUDA cores. One block: keys [split * keys_per_split,
// +keys_per_split) of one (batch row, kv head), all R <= kMaxDecodeRows of
// its query rows. Writes the partial m, l [R] and o [R][D] (unnormalised)
// at its place in the workspace: [B][KV][n_split][R].
template <int DS, bool PAD>
__global__ void __launch_bounds__(kThreads)
    decode_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ pool_k,
                      const float* __restrict__ pool_v,
                      const int* __restrict__ tables,
                      const int* __restrict__ positions,
                      float* __restrict__ part_o, float* __restrict__ part_ml,
                      int n_t, int H, int KV, int BS, int nblk,
                      int keys_per_split, int dh, int d_scale) {
  using S = DecodeF32Smem<DS>;
  const int D = PAD ? dh : DS;
  constexpr int LD = S::LD, SLD = S::SLD, VN = 4;
  // scores: thread -> one key of the tile and every second row
  constexpr int kScoreRowStep = kThreads / kKeyTile;
  constexpr int kScoreRows = kMaxDecodeRows / kScoreRowStep;
  // P.V: thread -> 4 dims of one row per pass
  constexpr int kThrPerRow = DS / 4;
  constexpr int kRowsPerPass = kThreads / kThrPerRow;
  constexpr int kPasses = (kMaxDecodeRows + kRowsPerPass - 1) / kRowsPerPass;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kStages * kKeyTile * LD;
  float* sQ = sV + kStages * kKeyTile * LD;
  float* sS = sQ + kMaxDecodeRows * LD;
  float* sM = sS + kMaxDecodeRows * SLD;  // running max per row
  float* sL = sM + kMaxDecodeRows;        // running sum per row
  float* sA = sL + kMaxDecodeRows;        // this tile's rescale per row
  int* sOk = reinterpret_cast<int*>(sA + kMaxDecodeRows);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, R = n_t * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* tbl = tables + (size_t)b * nblk;
  const int pos = positions[b];
  const int k_begin = split * keys_per_split;
  const size_t part = (((size_t)b * KV + kvh) * gridDim.x + split) * R;
  const int k_end = decode_range(tbl, pos, n_t, k_begin, keys_per_split, BS,
                                 nblk, R, part, part_o, part_ml, D);
  if (k_end < 0) return;

  for (int i = threadIdx.x; i < kMaxDecodeRows * (DS / VN); i += kThreads) {
    const int r = i / (DS / VN), c = (i % (DS / VN)) * VN;
    const bool in = r < R && (!PAD || c < D);
    const float* src =
        in ? q + (((size_t)b * n_t + r / G) * H + kvh * G + r % G) * D + c
           : q;
    cp_async16(sQ + r * LD + c, src, in);
  }
  const int n_tiles = (k_end - k_begin + kKeyTile - 1) / kKeyTile;
  load_kv_tile<float, DS, LD>(sK, sV, sOk, pool_k, pool_v, tbl, k_begin,
                              k_end, BS, KV, kvh, D);
  cp_async_commit();
  if (threadIdx.x < kMaxDecodeRows) {
    sM[threadIdx.x] = -INFINITY;
    sL[threadIdx.x] = 0.f;
  }

  const int sc_key = threadIdx.x % kKeyTile;
  const int sc_row0 = threadIdx.x / kKeyTile;
  const int pv_row0 = threadIdx.x / kThrPerRow;
  const int pv_d = (threadIdx.x % kThrPerRow) * 4;
  const float scale_div = sqrtf((float)d_scale);  // divide after the dot
  float acc[kPasses][4];
#pragma unroll
  for (int pi = 0; pi < kPasses; ++pi)
    acc[pi][0] = acc[pi][1] = acc[pi][2] = acc[pi][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int c0 = k_begin + it * kKeyTile;
    if (it + 1 < n_tiles) {
      const int nx = (it + 1) % kStages;
      load_kv_tile<float, DS, LD>(
          sK + nx * kKeyTile * LD, sV + nx * kKeyTile * LD,
          sOk + nx * kKeyTile, pool_k, pool_v, tbl, c0 + kKeyTile, k_end, BS,
          KV, kvh, D);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed; the next may still fly
    __syncthreads();
    const float* kst = sK + st * kKeyTile * LD;
    const float* vst = sV + st * kKeyTile * LD;
    const int* ok = sOk + st * kKeyTile;

    // scores of key sc_key against rows sc_row0, sc_row0 + 2, ...
    {
      float s[kScoreRows];
#pragma unroll
      for (int i = 0; i < kScoreRows; ++i) s[i] = 0.f;
#pragma unroll
      for (int c = 0; c < DS; c += VN) {
        float kf[VN];
        load16(kst + sc_key * LD + c, kf);
#pragma unroll
        for (int i = 0; i < kScoreRows; ++i) {
          const int r = sc_row0 + i * kScoreRowStep;
          if (r < R) {
            float qf[VN];
            load16(sQ + r * LD + c, qf);
#pragma unroll
            for (int e = 0; e < VN; ++e) s[i] += qf[e] * kf[e];
          }
        }
      }
      const int j = c0 + sc_key;
      const bool loaded = ok[sc_key] != 0;
#pragma unroll
      for (int i = 0; i < kScoreRows; ++i) {
        const int r = sc_row0 + i * kScoreRowStep;
        if (r < R)
          sS[r * SLD + sc_key] =
              loaded && j <= pos + r / G ? s[i] / scale_div : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 4, ...
    for (int r = warp; r < R; r += kWarps) {
      float* srow = sS + r * SLD;
      const float x0 = srow[lane], x1 = srow[lane + 32];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      float p0 = 0.f, p1 = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        p0 = expf(x0 - m_new);
        p1 = expf(x1 - m_new);
        alpha = expf(m_old - m_new);
      }
      srow[lane] = p0;
      srow[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        sL[r] = sL[r] * alpha + psum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // P.V; keys this tile did not load are zeros with p = 0
#pragma unroll
    for (int pi = 0; pi < kPasses; ++pi) {
      const int r = pv_row0 + pi * kRowsPerPass;
      if (r < R) {
        const float a = sA[r];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pi][e] *= a;
      }
    }
#pragma unroll 16
    for (int jj = 0; jj < kKeyTile; ++jj) {
      float vf[4];
      load16(vst + jj * LD + pv_d, vf);
#pragma unroll
      for (int pi = 0; pi < kPasses; ++pi) {
        const int r = pv_row0 + pi * kRowsPerPass;
        if (r < R) {
          const float p = sS[r * SLD + jj];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[pi][e] += p * vf[e];
        }
      }
    }
    __syncthreads();  // this stage is free for the load two tiles on
  }

#pragma unroll
  for (int pi = 0; pi < kPasses; ++pi) {
    const int r = pv_row0 + pi * kRowsPerPass;
    if (r < R && (!PAD || pv_d < D))
      *reinterpret_cast<float4*>(part_o + (part + r) * D + pv_d) =
          make_float4(acc[pi][0], acc[pi][1], acc[pi][2], acc[pi][3]);
  }
  if (threadIdx.x < R) {
    part_ml[2 * (part + threadIdx.x)] = sM[threadIdx.x];
    part_ml[2 * (part + threadIdx.x) + 1] = sL[threadIdx.x];
  }
}

template <int DS, int NC = 1>
struct DecodeMmaSmem {
  static constexpr int DP = DS;
  static constexpr int ST = bf16_stages(DS);
  // +8: fragment loads hit distinct banks; q and k rows hold every column
  // chunk, v rows the block's part
  static constexpr int LDK = NC * DP + 8, LD = DP + 8;
  static constexpr size_t kv =
      sizeof(uint16_t) * ST * kKeyTile * (LDK + LD);
  // after the last tile the ring holds each warp's (o, m, l) for the merge
  static_assert(sizeof(float) * kWarps * kMaxDecodeRows * (DS + 2) <= kv,
                "the warps' partials must fit in the K/V ring");
  static constexpr size_t bytes = kv + sizeof(uint16_t) * kMaxDecodeRows * LDK +
                                  sizeof(int) * ST * kKeyTile;
};

// bf16 decode on the tensor cores. One block as above; the 16 rows of the
// query tile (R <= 16 real) are the A operand of mma.sync, and warp w takes
// keys w * 16 .. w * 16 + 15 of each 64-key tile with an online softmax of
// its own. At the end the four warps' (m, l, o) are merged, in warp order,
// into the block's partial. Up to DS 128 the query's fragments stay in
// registers and the ring has two stages. At DS 256 (head dims 136 .. 256)
// a warp's o is 16 x 256 fp32, 128 registers a lane: the query's
// fragments are read from shared memory at each k step instead, and the
// ring has one stage (76 KB, three blocks an SM). Above 256 (NC = 2, D up
// to 512) the grid's z dimension also takes the output's 256-column parts:
// each block scores over both column chunks of q and k and sums its own
// part of v; the block of part 0 writes m and l. At DS 256 the fragments
// come by ldmatrix, and the grid's y dimension also takes the rows in
// tiles of 16 (R up to kMaxDecodeRowsWide: Gemma-2B's verify step has 32,
// which the prefill design gave only B x KV = 8 blocks), each block the
// keys of its range for its 16 rows; a range holds at least a whole
// 64-key tile (ops/paged.py decode_plan): a block's fixed cost, its 16 x
// 256 fp32 partial and the warps' merge through shared memory, is four
// times D 64's. A tile row is 32 16-byte chunks, so each warp's pass of
// the copy lies in one key row: load_kv_tile works out the row's pool
// offset once (one table read, one division by the block size) instead
// of once a chunk, which had cost more instructions than the products.
// Measured at Gemma-2B's attention (H 8, KV 1, D 256, L 2048, bf16;
// chip_smoke.py phase 2 on an NVIDIA H100 80GB HBM3 at 700 W), graph
// replay: decode B 8 0.01870 ms (SDPA on gathered KV 0.01483;
// paged_wide_kernel in bf16 0.1343), the verify step (T 4) 0.03502 (SDPA
// 0.1149); 190 registers, no spills.
template <int DS, bool PAD, int NC = 1>
__global__ void __launch_bounds__(kThreads)
    decode_bf16_kernel(const uint16_t* __restrict__ q,
                       const uint16_t* __restrict__ pool_k,
                       const uint16_t* __restrict__ pool_v,
                       const int* __restrict__ tables,
                       const int* __restrict__ positions,
                       float* __restrict__ part_o,
                       float* __restrict__ part_ml, int n_t, int H, int KV,
                       int BS, int nblk, int keys_per_split, int dh,
                       int d_scale) {
  using S = DecodeMmaSmem<DS, NC>;
  constexpr int LD = S::LD, LDK = S::LDK, DP = S::DP, ST = S::ST;
  constexpr bool kQRegs = DS <= 128;  // the query's fragments in registers
  const int D = PAD ? dh : NC * DS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sV = sK + ST * kKeyTile * LDK;
  uint16_t* sQ = sV + ST * kKeyTile * LD;
  int* sOk = reinterpret_cast<int*>(sQ + kMaxDecodeRows * LDK);

  const int split = blockIdx.x, kvh = blockIdx.y % KV, b = blockIdx.z / NC;
  const int cv0 = blockIdx.z % NC * DS, Dv = min(DS, D - cv0);
  const int G = H / KV, R = n_t * G;
  // this block's rows: [r0, r0 + Rb) of the (b, kv head)'s R
  const int r0 = blockIdx.y / KV * kMaxDecodeRows;
  const int Rb = min(kMaxDecodeRows, R - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int* tbl = tables + (size_t)b * nblk;
  const int pos = positions[b];
  const int k_begin = split * keys_per_split;
  const size_t part =
      (((size_t)b * KV + kvh) * gridDim.x + split) * R + r0;
  const int k_end = decode_range(tbl, pos, n_t, k_begin, keys_per_split, BS,
                                 nblk, Rb, part, part_o, part_ml, D, cv0, Dv);
  if (k_end < 0) return;

  if constexpr (DS >= 256) {
    load_q_rows<kMaxDecodeRows, NC * DP, LDK>(sQ, q, r0, R, b, n_t, H, G,
                                              kvh, D);
  } else {
    for (int i = threadIdx.x; i < kMaxDecodeRows * (NC * DP / 8);
         i += kThreads) {
      const int r = i / (NC * DP / 8), c = (i % (NC * DP / 8)) * 8;
      const int rr = r0 + r;
      const bool in = r < Rb && c < D;
      const uint16_t* src =
          in ? q + (((size_t)b * n_t + rr / G) * H + kvh * G + rr % G) * D +
                   c
             : q;
      cp_async16(sQ + r * LDK + c, src, in);
    }
  }
  const int n_tiles = (k_end - k_begin + kKeyTile - 1) / kKeyTile;
  auto load = [&](int it) {
    const int st = it % ST;
    load_kv_tile<uint16_t, NC * DP, LDK, DP, LD>(
        sK + st * kKeyTile * LDK, sV + st * kKeyTile * LD,
        sOk + st * kKeyTile, pool_k, pool_v, tbl, k_begin + it * kKeyTile,
        k_end, BS, KV, kvh, D, cv0);
  };
  load(0);
  cp_async_commit();

  const int rows[2] = {g, g + 8};
  const int lim[2] = {pos + (r0 + g) / G, pos + (r0 + g + 8) / G};
  const float scale = rsqrtf((float)d_scale);
  const int kw = warp * 16;  // this warp's keys in each tile
  uint32_t qa[kQRegs ? DP / 16 : 1][4];
  float o[DS / 8][4];
#pragma unroll
  for (int j = 0; j < DS / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % ST;
    const int c0 = k_begin + it * kKeyTile;
    if constexpr (ST == 2) {
      if (it + 1 < n_tiles) load(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kQRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? DP / 16 : 0); ++kk)
        frag_a<LDK>(qa[kk], sQ, 0, kk * 16, lane);
    }
    const uint16_t* kst = sK + st * kKeyTile * LDK;
    const uint16_t* vst = sV + st * kKeyTile * LD;
    const int* ok = sOk + st * kKeyTile;

    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (kQRegs) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bk[2];
          frag_b_nk<LDK>(bk, kst, kw + j * 8, kk * 16, lane);
          mma_bf16(s[j], qa[kQRegs ? kk : 0], bk);
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < NC * DP / 16; ++kk) {
        uint32_t a[4], bk[2][2];
        frag_a_ldsm<LDK>(a, sQ, 0, kk * 16, lane);
        frag_b_nk2<LDK>(bk, kst, kw, kk * 16, lane);
        mma_bf16(s[0], a, bk[0]);
        mma_bf16(s[1], a, bk[1]);
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = kw + j * 8 + 2 * t4 + (e & 1);
        const float x = ok[jj] && c0 + jj <= lim[e >> 1]
                            ? s[j][e] * scale
                            : kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      safe[r] = mx[r] <= kMaskedBelow ? 0.f : mx[r];
      const float corr =
          m[r] <= kMaskedBelow ? 0.f : __expf(fminf(m[r] - safe[r], 0.f));
      l[r] *= corr;
#pragma unroll
      for (int jd = 0; jd < DS / 8; ++jd) {
        o[jd][2 * r] *= corr;
        o[jd][2 * r + 1] *= corr;
      }
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pe = x <= kMaskedBelow ? 0.f : __expf(x - safe[e >> 1]);
        s[j][e] = pe;
        l[e >> 1] += pe;
      }
    uint32_t pa[4];
    pa[0] = pack_bf16(s[0][0], s[0][1]);
    pa[1] = pack_bf16(s[0][2], s[0][3]);
    pa[2] = pack_bf16(s[1][0], s[1][1]);
    pa[3] = pack_bf16(s[1][2], s[1][3]);
    if constexpr (kQRegs) {
#pragma unroll
      for (int jd = 0; jd < DS / 8; ++jd) {
        uint32_t bv[2];
        frag_b_kn<LD>(bv, vst, kw, jd * 8, lane);
        mma_bf16(o[jd], pa, bv);
      }
    } else {
#pragma unroll
      for (int jd = 0; jd < DS / 8; jd += 2) {
        uint32_t bv[2][2];
        frag_b_kn2<LD>(bv, vst, kw, jd * 8, lane);
        mma_bf16(o[jd], pa, bv[0]);
        mma_bf16(o[jd + 1], pa, bv[1]);
      }
    }
    __syncthreads();  // this stage is free for the next load into it
    if constexpr (ST == 1) {
      if (it + 1 < n_tiles) load(it + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // the warps' (o, m, l) into the free ring, then merged in warp order
  float* wo = reinterpret_cast<float*>(smem_raw);  // [kWarps][16][DS]
  float* wm = wo + kWarps * kMaxDecodeRows * DS;  // [kWarps][16]
  float* wl = wm + kWarps * kMaxDecodeRows;       // [kWarps][16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (rows[r] >= Rb) continue;  // a padding row: never merged
    float* dst = wo + (warp * kMaxDecodeRows + rows[r]) * DS + 2 * t4;
#pragma unroll
    for (int jd = 0; jd < DS / 8; ++jd) {
      dst[jd * 8] = o[jd][2 * r];
      dst[jd * 8 + 1] = o[jd][2 * r + 1];
    }
    if (t4 == 0) {
      wm[warp * kMaxDecodeRows + rows[r]] = m[r];
      wl[warp * kMaxDecodeRows + rows[r]] = l[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Rb * Dv; i += kThreads) {
    const int r = i / Dv, d = i % Dv;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kMaxDecodeRows + r]);
    float acc = 0.f, L = 0.f;
    if (M > kMaskedBelow) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = wm[w * kMaxDecodeRows + r];
        const float f = mw <= kMaskedBelow ? 0.f : __expf(mw - M);
        acc += wo[(w * kMaxDecodeRows + r) * DS + d] * f;
        L += wl[w * kMaxDecodeRows + r] * f;
      }
    }
    part_o[(part + r) * D + cv0 + d] = acc;
    if (d == 0 && cv0 == 0) {
      part_ml[2 * (part + r)] = M > kMaskedBelow ? M : -INFINITY;
      part_ml[2 * (part + r) + 1] = L;
    }
  }
}

// One block per output row (b, t, h): the weights exp(m_s - max m) of the
// row's n_split partials, then warp w sums the w-th quarter of them in
// split order and the quarters are added in warp order: no atomics, the
// same bits on every run. No valid key anywhere (every m_s = -inf) writes
// zeros.
template <typename T, int DS, bool PAD>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ part_o,
                   const float* __restrict__ part_ml, T* __restrict__ out,
                   int n_t, int H, int KV, int n_split, int dh) {
  constexpr int E = (DS + 31) / 32;  // dims a lane owns; lanes past D idle
  const int D = PAD ? dh : DS;
  extern __shared__ float sW[];  // [n_split]: each m_s, then its weight
  __shared__ float sAcc[kWarps][DS], sL[kWarps], sMax[kWarps];
  const int row = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int h = row % H, t = (row / H) % n_t, b = row / (H * n_t);
  const int G = H / KV, R = n_t * G;
  const int r = t * G + h % G;
  const size_t base = ((size_t)b * KV + h / G) * n_split;
  float M = -INFINITY;
  for (int s = threadIdx.x; s < n_split; s += kThreads) {
    sW[s] = part_ml[2 * ((base + s) * R + r)];
    M = fmaxf(M, sW[s]);
  }
  M = warp_max(M);
  if (lane == 0) sMax[warp] = M;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sMax[w]);
  for (int s = threadIdx.x; s < n_split; s += kThreads)
    sW[s] = sW[s] == -INFINITY ? 0.f : expf(sW[s] - M);
  __syncthreads();
  const int per = (n_split + kWarps - 1) / kWarps;
  const int s1 = min(n_split, (warp + 1) * per);
  float acc[E], L = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int s = warp * per; s < s1; ++s) {
    const size_t i = (base + s) * R + r;
    const float w = sW[s];
    L += part_ml[2 * i + 1] * w;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (lane + 32 * e < D) acc[e] += part_o[i * D + lane + 32 * e] * w;
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (lane + 32 * e < D) sAcc[warp][lane + 32 * e] = acc[e];
  if (lane == 0) sL[warp] = L;
  __syncthreads();
  if (warp != 0) return;
  float tot_l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot_l += sL[w];
  const float inv = tot_l > 0.f ? 1.f / tot_l : 0.f;
  T* dst = out + (size_t)row * D;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (lane + 32 * e >= D) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += sAcc[w][lane + 32 * e];
    store(v * inv, dst + lane + 32 * e);
  }
}

// ---------------------------------------------------------------------------
// prefill, bf16: tensor cores
// ---------------------------------------------------------------------------

template <int DS, int NC = 1>
struct PrefillSmem {
  static constexpr int DP = DS;
  static constexpr int ST = bf16_stages(DS);
  // +8: fragment loads hit distinct banks; q and k rows hold every column
  // chunk, v rows the block's part
  static constexpr int LDK = NC * DP + 8, LD = DP + 8;
  static constexpr size_t bytes =
      sizeof(uint16_t) * ((kQueryTile + ST * kKeyTile) * LDK +
                          ST * kKeyTile * LD) +
      sizeof(int) * ST * kKeyTile;
};

// One block: 64 query rows (r = t * G + g) of one (batch row, kv head);
// warp w owns rows w * 16 .. w * 16 + 15. At DS 256 (head dims 136 ..
// 256) a warp's o is 128 registers a lane and the ring has one stage (99
// KB, two blocks an SM: a second stage measured slower, 0.162 against
// 0.124 ms, in a build timed and then taken out); the fragments come by
// ldmatrix and the copies work out a row's pool offset once, as in the
// decode design. Above 256 (NC = 2) the grid's z dimension also takes the
// output's 256-column parts, each block scoring over both column chunks
// of q and k and summing its own part of v. Measured (chip_smoke.py phase
// 2, as the decode design's note): prefill B 8 x 512 at D 256 0.08049 ms
// (SDPA 0.03528, paged_wide_kernel 2.966), D 512 0.2493; 240 registers, no
// spills.
template <int DS, bool PAD, int NC = 1>
__global__ void __launch_bounds__(kThreads)
    prefill_bf16_kernel(const uint16_t* __restrict__ q,
                        const uint16_t* __restrict__ pool_k,
                        const uint16_t* __restrict__ pool_v,
                        const int* __restrict__ tables,
                        const int* __restrict__ positions,
                        uint16_t* __restrict__ out, int n_t, int H, int KV,
                        int BS, int nblk, int dh, int d_scale) {
  using S = PrefillSmem<DS, NC>;
  constexpr int LD = S::LD, LDK = S::LDK, DP = S::DP, ST = S::ST;
  const int D = PAD ? dh : NC * DS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sK = sQ + kQueryTile * LDK;
  uint16_t* sV = sK + ST * kKeyTile * LDK;
  int* sOk = reinterpret_cast<int*>(sV + ST * kKeyTile * LD);

  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest tiles first
  const int kvh = blockIdx.y, b = blockIdx.z / NC;
  const int cv0 = blockIdx.z % NC * DS;
  const int G = H / KV, R = n_t * G;
  const int r0 = tile * kQueryTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int pos = positions[b];
  const int* tbl = tables + (size_t)b * nblk;

  if constexpr (DS >= 256) {
    load_q_rows<kQueryTile, NC * DP, LDK>(sQ, q, r0, R, b, n_t, H, G, kvh,
                                          D);
  } else {
    for (int i = threadIdx.x; i < kQueryTile * (NC * DP / 8);
         i += kThreads) {
      const int rl = i / (NC * DP / 8), c = (i % (NC * DP / 8)) * 8;
      const int r = r0 + rl;
      const bool in = r < R && c < D;
      const uint16_t* src =
          in ? q + (((size_t)b * n_t + r / G) * H + kvh * G + r % G) * D + c
             : q;
      cp_async16(sQ + rl * LDK + c, src, in);
    }
  }
  // the last key any row of the tile may attend, and the first row's limit
  const int r_last = min(r0 + kQueryTile, R) - 1;
  const int k_end = min(pos + r_last / G + 1, nblk * BS);
  const int lim_min = pos + r0 / G;
  const int n_tiles = (k_end + kKeyTile - 1) / kKeyTile;
  auto load = [&](int it) {
    const int st = it % ST;
    return load_kv_tile<uint16_t, NC * DP, LDK, DP, LD>(
        sK + st * kKeyTile * LDK, sV + st * kKeyTile * LD,
        sOk + st * kKeyTile, pool_k, pool_v, tbl, it * kKeyTile, k_end, BS,
        KV, kvh, D, cv0);
  };
  bool unloaded_next = false;
  if (n_tiles > 0) unloaded_next = load(0);
  cp_async_commit();

  const int rows[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
  const int lim[2] = {pos + rows[0] / G, pos + rows[1] / G};
  const float scale = rsqrtf((float)d_scale);
  float o[DS / 8][4];
#pragma unroll
  for (int j = 0; j < DS / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % ST;
    const int c0 = it * kKeyTile;
    const bool unloaded = unloaded_next;
    if constexpr (ST == 2) {
      if (it + 1 < n_tiles) unloaded_next = load(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // mask only a tile that holds an unloaded key or crosses a limit
    const bool edge =
        __syncthreads_or(unloaded) || c0 + kKeyTile - 1 > lim_min;
    const uint16_t* kst = sK + st * kKeyTile * LDK;
    const uint16_t* vst = sV + st * kKeyTile * LD;
    const int* ok = sOk + st * kKeyTile;

    float s[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_qk<NC * DP, LDK>(s, sQ, kst, warp * 16, lane);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int jj = j * 8 + 2 * t4 + (e & 1);
          if (!ok[jj] || c0 + jj > lim[e >> 1]) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      safe[r] = mx[r] <= kMaskedBelow ? 0.f : mx[r];
      const float corr =
          m[r] <= kMaskedBelow ? 0.f : __expf(fminf(m[r] - safe[r], 0.f));
      l[r] *= corr;
#pragma unroll
      for (int jd = 0; jd < DS / 8; ++jd) {
        o[jd][2 * r] *= corr;
        o[jd][2 * r + 1] *= corr;
      }
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pe = x <= kMaskedBelow ? 0.f : __expf(x - safe[e >> 1]);
        s[j][e] = pe;
        l[e >> 1] += pe;
      }
    mma_pv<DS, LD>(o, s, vst, lane);
    __syncthreads();  // this stage is free for the next load into it
    if constexpr (ST == 1) {
      if (it + 1 < n_tiles) unloaded_next = load(it + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (rows[r] >= R) continue;
    // a row that saw no valid key (l = 0) writes zeros
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    uint16_t* dst = out +
                    (((size_t)b * n_t + rows[r] / G) * H + kvh * G +
                     rows[r] % G) * D + cv0 + 2 * t4;
#pragma unroll
    for (int jd = 0; jd < DS / 8; ++jd)
      if (!PAD || cv0 + jd * 8 < D)
        *reinterpret_cast<uint32_t*>(dst + jd * 8) =
            pack_bf16(o[jd][2 * r] * inv, o[jd][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// prefill, fp32: CUDA cores, 32 keys staged per pass as fp32
// ---------------------------------------------------------------------------

constexpr int kChunk = 32;  // keys staged per pass: one per lane

// One block: QT query rows (row r = t * G + g) of one (batch row, kv head).
// Warp w owns rows w, w + 4, w + 8, ...; lane i scores staged key i and
// accumulates output dims i, i + 32, ...
template <int DS, bool PAD, int QT>
__global__ void __launch_bounds__(kThreads)
    prefill_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ pool_k,
                       const float* __restrict__ pool_v,
                       const int* __restrict__ tables,
                       const int* __restrict__ positions,
                       float* __restrict__ out, int n_t, int H, int KV, int BS,
                       int nblk, int dh, int d_scale) {
  constexpr int kDimsPerLane = (DS + 31) / 32;  // lanes past D idle
  constexpr int kRowsPerWarp = QT / kWarps;
  constexpr int kVecPerRow = DS / 4;
  const int D = PAD ? dh : DS;

  __shared__ float q_s[QT][DS];
  __shared__ float k_s[kChunk][DS + 1];  // +1: lane-strided reads hit
                                         // distinct banks
  __shared__ float v_s[kChunk][DS];
  __shared__ float p_s[kWarps][kChunk];
  __shared__ int blk_s[kChunk];

  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int rows = n_t * G;
  const int r0 = tile * QT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pos = positions[b];
  const int* tbl = tables + (size_t)b * nblk;

  for (int i = threadIdx.x; i < QT * kVecPerRow; i += kThreads) {
    const int rl = i / kVecPerRow;
    const int c = i % kVecPerRow;
    const int r = r0 + rl;
    float tmp[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows && (!PAD || c * 4 < D))
      load16(q + (((size_t)b * n_t + r / G) * H + kvh * G + r % G) * D +
                 c * 4,
             tmp);
#pragma unroll
    for (int e = 0; e < 4; ++e) q_s[rl][c * 4 + e] = tmp[e];
  }

  // the last key any row of this tile may attend
  const int r_last = min(r0 + QT, rows) - 1;
  const int n_keys = min(pos + r_last / G + 1, nblk * BS);

  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < kDimsPerLane; ++k) acc[i][k] = 0.f;
  }
  const float scale_div = sqrtf((float)d_scale);

  for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed by every warp
    if (threadIdx.x < kChunk) {
      const int j = c0 + threadIdx.x;
      blk_s[threadIdx.x] = j < n_keys ? tbl[j / BS] : -1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * kVecPerRow; i += kThreads) {
      const int jl = i / kVecPerRow;
      const int c = i % kVecPerRow;
      const int blk = blk_s[jl];
      float tk[4] = {0.f, 0.f, 0.f, 0.f};
      float tv[4] = {0.f, 0.f, 0.f, 0.f};
      if (blk >= 0 && (!PAD || c * 4 < D)) {
        const int j = c0 + jl;
        const size_t off =
            (((size_t)blk * BS + j % BS) * KV + kvh) * D + c * 4;
        load16(pool_k + off, tk);
        load16(pool_v + off, tv);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k_s[jl][c * 4 + e] = tk[e];
        v_s[jl][c * 4 + e] = tv[e];
      }
    }
    __syncthreads();

    const bool key_ok = blk_s[lane] >= 0;
    const int j = c0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rl = warp + i * kWarps;
      const int r = r0 + rl;
      const int lim = pos + r / G;  // the last key row r may attend
      // both conditions are uniform across the warp
      if (r < rows && lim >= c0) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < DS; ++d) s += q_s[rl][d] * k_s[lane][d];
        s = s / scale_div;
        const bool valid = key_ok && j <= lim;
        s = valid ? s : -INFINITY;
        const float m_new = fmaxf(m[i], warp_max(s));
        if (m_new != -INFINITY) {
          const float p = valid ? expf(s - m_new) : 0.f;
          const float alpha = expf(m[i] - m_new);
          l[i] = l[i] * alpha + warp_sum(p);
          m[i] = m_new;
          p_s[warp][lane] = p;
          __syncwarp();
          // keys past lim are never touched: their bytes may be stale
          const int jmax = min(kChunk, lim - c0 + 1);
#pragma unroll
          for (int k = 0; k < kDimsPerLane; ++k) acc[i][k] *= alpha;
          for (int jj = 0; jj < jmax; ++jj) {
            const float pj = p_s[warp][jj];
#pragma unroll
            for (int k = 0; k < kDimsPerLane; ++k)
              if (lane + 32 * k < D) acc[i][k] += pj * v_s[jj][lane + 32 * k];
          }
          __syncwarp();
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + warp + i * kWarps;
    if (r < rows) {
      const int t = r / G;
      const int g = r % G;
      // a row that saw no valid key (an inactive batch row) writes zeros
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      float* dst = out + (((size_t)b * n_t + t) * H + kvh * G + g) * D;
#pragma unroll
      for (int k = 0; k < kDimsPerLane; ++k)
        if (lane + 32 * k < D) dst[lane + 32 * k] = acc[i][k] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// head dims 129 .. 512, fp32: one simple design for every T
// ---------------------------------------------------------------------------
//
// The same function for D in (128, 512] in fp32, for decode, prefill and
// the verify step alike: paged_wide_kernel replaces
// horovod_tpu/ops/pallas_paged.py:_paged_attn_kernel at those head dims
// in fp32 (bf16 runs decode_bf16_kernel / prefill_bf16_kernel at DS 256;
// bf16 once ran here too, converted as it was staged). It serves the fp32
// parity runs, written to be right first: fp32 math on the CUDA cores.
//   * Grid (n_split, row tiles, B * KV * parts): a block takes kWideRows =
//     16 query rows r = t * G + g of one (batch row, kv head), one range of
//     keys_per_split keys (whole pages, ops/paged.py split_plan over the
//     row tiles) and one 256-column part of the output (two above 256), so
//     a decode step still spreads one row's keys over many blocks. Each
//     block writes its partial (m, l by part 0, unnormalised o in its
//     part's columns) to the workspace, and combine_kernel (above) merges
//     the ranges in fixed order, as for the decode design.
//   * Keys are staged 32 a pass through the block table as fp32 rows: k
//     whole (kWideLD = 257 floats, 513 above 256: the odd stride spreads
//     the lanes' rows over distinct banks), v in the part's columns. Keys
//     past the range, past the last key the tile's rows may see, or in a
//     -1 page are zero-filled and never read from the pool.
//   * Scores: lane j of warp w scores key j against rows w, w + 4, w + 8,
//     w + 12, so each row's online softmax is one warp's shuffles. P.V:
//     thread c owns columns c and c + 128 of the part for all 16 rows, in
//     registers.
// What bounds it: at decode the KV bytes (as for the decode design), but
// this design reaches well under that rate: 32 keys a pass with scalar
// loads and one barrier a stage, and the products read shared memory once
// per fma. A D that is not a multiple of 8 is zero-padded by the wrapper.
// Measured (chip_smoke.py phase 2, fp32, on an NVIDIA H100 80GB HBM3 at
// 700 W): decode B 8, L 2048, H 8, KV 1, D 256 0.1689 ms against a 0.0101
// ms byte bound.

constexpr int kWideD = 256;  // columns of an output part
constexpr int kWideLD = kWideD + 1;
constexpr int kWideLD2 = 2 * kWideD + 1;  // k rows above 256
constexpr int kWideRows = 16;  // query rows of a block
constexpr int kWideKeys = 32;  // keys staged a pass: one per lane
constexpr int kWidePLD = kWideKeys + 1;
size_t wide_smem(int D) {
  const size_t ld = D > kWideD ? kWideLD2 : kWideLD;
  return sizeof(float) * ((kWideRows + kWideKeys) * ld +
                          kWideKeys * kWideLD + kWideRows * kWidePLD +
                          kWideRows) +
         sizeof(int) * kWideKeys;
}

__global__ void __launch_bounds__(kThreads)
    paged_wide_kernel(const float* __restrict__ q,
                      const float* __restrict__ pool_k,
                      const float* __restrict__ pool_v,
                      const int* __restrict__ tables,
                      const int* __restrict__ positions,
                      float* __restrict__ part_o, float* __restrict__ part_ml,
                      int n_t, int H, int KV, int BS, int nblk,
                      int keys_per_split, int D, int d_scale) {
  const int np = (D + kWideD - 1) / kWideD;
  const int ld = np > 1 ? kWideLD2 : kWideLD;  // q and k rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kWideRows][ld]
  float* sK = sQ + kWideRows * ld;                 // [kWideKeys][ld]
  float* sV = sK + kWideKeys * ld;                 // [kWideKeys][kWideLD]
  float* sP = sV + kWideKeys * kWideLD;            // [kWideRows][kWidePLD]
  float* sA = sP + kWideRows * kWidePLD;           // this pass's rescale
  int* sBlk = reinterpret_cast<int*>(sA + kWideRows);
  const int split = blockIdx.x, r0 = blockIdx.y * kWideRows;
  const int cv0 = blockIdx.z % np * kWideD, Dv = min(kWideD, D - cv0);
  const int kvh = blockIdx.z / np % KV, b = blockIdx.z / np / KV;
  const int G = H / KV, R = n_t * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* tbl = tables + (size_t)b * nblk;
  const int pos = positions[b];
  const int k_begin = split * keys_per_split;
  const int r_last = min(r0 + kWideRows, R) - 1;
  // the range's end, capped at the pool row and the last key a row sees
  const int k_end = min(min(k_begin + keys_per_split, nblk * BS),
                        pos + r_last / G + 1);
  for (int i = threadIdx.x; i < kWideRows * D; i += kThreads) {
    const int rl = i / D, c = i - rl * D, r = r0 + rl;
    sQ[rl * ld + c] =
        r < R ? q[(((size_t)b * n_t + r / G) * H + kvh * G + r % G) * D + c]
              : 0.f;
  }
  constexpr int kRowsPerWarp = kWideRows / kWarps;
  float m[kRowsPerWarp], l[kRowsPerWarp];  // warp-uniform
  float acc[kWideRows][2];                 // columns c and c + 128
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kWideRows; ++i) acc[i][0] = acc[i][1] = 0.f;
  const float scale_div = sqrtf((float)d_scale);  // divide after the dot
  for (int c0 = k_begin; c0 < k_end; c0 += kWideKeys) {
    __syncthreads();  // the previous pass is consumed
    if (threadIdx.x < kWideKeys) {
      const int j = c0 + threadIdx.x;
      sBlk[threadIdx.x] = j < k_end ? tbl[j / BS] : -1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kWideKeys * D; i += kThreads) {
      const int jl = i / D, c = i - jl * D;
      const int blk = sBlk[jl];
      const size_t off =
          (((size_t)blk * BS + (c0 + jl) % BS) * KV + kvh) * D + c;
      sK[jl * ld + c] = blk >= 0 ? pool_k[off] : 0.f;
      const int cv = c - cv0;
      if (cv >= 0 && cv < Dv)
        sV[jl * kWideLD + cv] = blk >= 0 ? pool_v[off] : 0.f;
    }
    __syncthreads();
    const int j = c0 + lane;
    const bool loaded = sBlk[lane] >= 0;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rl = warp + kWarps * i, r = r0 + rl;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s += sQ[rl * ld + d] * sK[lane * ld + d];
      const bool valid = r < R && loaded && j <= pos + r / G;
      s = valid ? s / scale_div : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(s));
      float pe = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        pe = valid ? expf(s - m_new) : 0.f;
        alpha = expf(m[i] - m_new);
      }
      l[i] = l[i] * alpha + warp_sum(pe);
      m[i] = m_new;
      sP[rl * kWidePLD + lane] = pe;
      if (lane == 0) sA[rl] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = threadIdx.x + kThreads * e;
      if (c >= Dv) continue;
#pragma unroll
      for (int rl = 0; rl < kWideRows; ++rl) acc[rl][e] *= sA[rl];
      for (int jj = 0; jj < kWideKeys; ++jj) {
        const float vv = sV[jj * kWideLD + c];
#pragma unroll
        for (int rl = 0; rl < kWideRows; ++rl)
          acc[rl][e] += sP[rl * kWidePLD + jj] * vv;
      }
    }
  }
  const size_t part = (((size_t)b * KV + kvh) * gridDim.x + split) * R;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int c = threadIdx.x + kThreads * e;
    if (c >= Dv) continue;
#pragma unroll
    for (int rl = 0; rl < kWideRows; ++rl)
      if (r0 + rl < R) part_o[(part + r0 + rl) * D + cv0 + c] = acc[rl][e];
  }
  if (lane == 0 && cv0 == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = r0 + warp + kWarps * i;
      if (r >= R) continue;
      part_ml[2 * (part + r)] = m[i];
      part_ml[2 * (part + r) + 1] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DS, bool PAD>
cudaError_t combine_d(const float* part_o, const float* part_ml, void* out,
                      int B, int n_t, int H, int KV, int D, int n_split,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * n_split;
  const cudaError_t err = allow_smem(combine_kernel<T, DS, PAD>, smem);
  if (err != cudaSuccess) return err;
  combine_kernel<T, DS, PAD><<<B * n_t * H, kThreads, smem, stream>>>(
      part_o, part_ml, static_cast<T*>(out), n_t, H, KV, n_split, D);
  return cudaGetLastError();
}

template <int DS, bool PAD, int NC = 1>
cudaError_t decode_d(const void* q, const void* pool_k, const void* pool_v,
                     const int* tables, const int* positions, void* out,
                     float* ws, int B, int n_t, int H, int KV, int D,
                     int d_scale, int BS, int nblk, int n_split,
                     int keys_per_split, int dtype, cudaStream_t stream) {
  const int R = n_t * (H / KV);
  float* part_o = ws;
  float* part_ml = ws + (size_t)B * KV * n_split * R * D;
  const int row_tiles = (R + kMaxDecodeRows - 1) / kMaxDecodeRows;
  const dim3 grid(n_split, KV * row_tiles, B * NC);
  cudaError_t err;
  if (dtype == 1) {
    const size_t smem = DecodeMmaSmem<DS, NC>::bytes;
    err = allow_smem(decode_bf16_kernel<DS, PAD, NC>, smem);
    if (err != cudaSuccess) return err;
    decode_bf16_kernel<DS, PAD, NC><<<grid, kThreads, smem, stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(pool_k),
        static_cast<const uint16_t*>(pool_v), tables, positions, part_o,
        part_ml, n_t, H, KV, BS, nblk, keys_per_split, D, d_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return NC == 1 ? combine_d<__nv_bfloat16, DS, PAD>(
                         part_o, part_ml, out, B, n_t, H, KV, D, n_split,
                         stream)
                   : combine_d<__nv_bfloat16, NC * DS, PAD>(
                         part_o, part_ml, out, B, n_t, H, KV, D, n_split,
                         stream);
  }
  if constexpr (DS <= 128) {
    const size_t smem = DecodeF32Smem<DS>::bytes;
    err = allow_smem(decode_f32_kernel<DS, PAD>, smem);
    if (err != cudaSuccess) return err;
    decode_f32_kernel<DS, PAD><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(pool_k),
        static_cast<const float*>(pool_v), tables, positions, part_o,
        part_ml, n_t, H, KV, BS, nblk, keys_per_split, D, d_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return combine_d<float, DS, PAD>(part_o, part_ml, out, B, n_t, H, KV, D,
                                     n_split, stream);
  }
  return cudaErrorInvalidValue;  // fp32 above 128: the wide design
}

template <int DS, bool PAD, int NC = 1>
cudaError_t prefill_bf16_d(const void* q, const void* pool_k,
                           const void* pool_v, const int* tables,
                           const int* positions, void* out, int B, int n_t,
                           int H, int KV, int D, int d_scale, int BS,
                           int nblk, cudaStream_t stream) {
  const size_t smem = PrefillSmem<DS, NC>::bytes;
  const cudaError_t err = allow_smem(prefill_bf16_kernel<DS, PAD, NC>, smem);
  if (err != cudaSuccess) return err;
  const int rows = n_t * (H / KV);
  const dim3 grid((rows + kQueryTile - 1) / kQueryTile, KV, B * NC);
  prefill_bf16_kernel<DS, PAD, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(pool_k),
      static_cast<const uint16_t*>(pool_v), tables, positions,
      static_cast<uint16_t*>(out), n_t, H, KV, BS, nblk, D, d_scale);
  return cudaGetLastError();
}

template <int DS, bool PAD>
cudaError_t prefill_f32_d(const void* q, const void* pool_k,
                          const void* pool_v, const int* tables,
                          const int* positions, void* out, int B, int n_t,
                          int H, int KV, int D, int d_scale, int BS, int nblk,
                          cudaStream_t stream) {
  constexpr int QT = DS <= 64 ? 64 : 16;  // static shared memory < 48 KB
  const int rows = n_t * (H / KV);
  const dim3 grid((rows + QT - 1) / QT, KV, B);
  prefill_f32_kernel<DS, PAD, QT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pool_k),
      static_cast<const float*>(pool_v), tables, positions,
      static_cast<float*>(out), n_t, H, KV, BS, nblk, D, d_scale);
  return cudaGetLastError();
}

template <bool PAD, int NC>
cudaError_t wide_d(const void* q, const void* pool_k, const void* pool_v,
                   const int* tables, const int* positions, void* out,
                   float* ws, int B, int n_t, int H, int KV, int D,
                   int d_scale, int BS, int nblk, int n_split,
                   int keys_per_split, cudaStream_t stream) {
  const int R = n_t * (H / KV);
  float* part_o = ws;
  float* part_ml = ws + (size_t)B * KV * n_split * R * D;
  const size_t smem = wide_smem(D);
  cudaError_t err = allow_smem(paged_wide_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, (R + kWideRows - 1) / kWideRows, B * KV * NC);
  paged_wide_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pool_k),
      static_cast<const float*>(pool_v), tables, positions, part_o, part_ml,
      n_t, H, KV, BS, nblk, keys_per_split, D, d_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return combine_d<float, NC * kWideD, PAD>(part_o, part_ml, out, B, n_t, H,
                                            KV, D, n_split, stream);
}

}  // namespace

// Common arguments: q [B, T, H, D]; pool_k / pool_v [NB, BS, KV, D] (q's
// type); tables [B, nblk] int32 (-1 = unassigned); positions [B] int32;
// out [B, T, H, D]. d_scale: the head dim whose 1 / sqrt scales the
// scores, D itself unless the wrapper zero-padded a head dim that is not
// a multiple of 8 up to D (the zero columns add nothing to a dot). dtype
// 0 = float32, 1 = bfloat16. All pointers are device pointers, 16-byte
// aligned, contiguous. Each returns the first failing launch's
// cudaError_t (0 on success).

// The decode design, for T * (H / KV) <= 16 (<= 64 in bf16 above head
// dim 128, in tiles of 16 rows): the split-KV kernel over n_split ranges
// of keys_per_split keys (a multiple of BS), then the combine. ws: B * KV
// * n_split * T * (H / KV) * (D + 2) floats. D up to 128 in fp32, up to
// 512 in bf16 (DS 256; two column parts above 256).
extern "C" int hvd_paged_attention_decode(
    const void* q, const void* pool_k, const void* pool_v, const int* tables,
    const int* positions, void* out, float* ws, int B, int n_t, int H,
    int KV, int D, int d_scale, int BS, int nblk, int n_split,
    int keys_per_split, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV || n_split <= 0 || keys_per_split <= 0 ||
      keys_per_split % BS || (long long)B * 2 > 65535 ||
      n_t * (H / KV) > (D > 128 ? kMaxDecodeRowsWide : kMaxDecodeRows))
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (D < 8 || D > (dtype == 1 ? 2 * kWideD : 128) || D % 8 || d_scale < 1 ||
      d_scale > D)
    return (int)cudaErrorInvalidValue;
#define HVD_DECODE(DS)                                                     \
  case DS:                                                                 \
    return (int)(D == DS ? decode_d<DS, false>(HVD_DECODE_ARGS)            \
                         : decode_d<DS, true>(HVD_DECODE_ARGS));
#define HVD_DECODE_ARGS                                                    \
  q, pool_k, pool_v, tables, positions, out, ws, B, n_t, H, KV, D,        \
      d_scale, BS, nblk, n_split, keys_per_split, dtype, s
  switch (stored_dim(D)) {
    HVD_DECODE(16)
    HVD_DECODE(32)
    HVD_DECODE(64)
    HVD_DECODE(128)
    case 256:
      if (D > kWideD)
        return (int)(D == 2 * kWideD
                         ? decode_d<256, false, 2>(HVD_DECODE_ARGS)
                         : decode_d<256, true, 2>(HVD_DECODE_ARGS));
      return (int)(D == kWideD ? decode_d<256, false>(HVD_DECODE_ARGS)
                               : decode_d<256, true>(HVD_DECODE_ARGS));
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HVD_DECODE_ARGS
#undef HVD_DECODE
}

// The prefill design, any T: tensor cores for bf16 (D up to 512, as the
// decode design), CUDA cores for fp32 (D up to 128).
extern "C" int hvd_paged_attention_prefill(
    const void* q, const void* pool_k, const void* pool_v, const int* tables,
    const int* positions, void* out, int B, int n_t, int H, int KV, int D,
    int d_scale, int BS, int nblk, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (KV <= 0 || H % KV || D < 8 || D > (dtype == 1 ? 2 * kWideD : 128) ||
      D % 8 || d_scale < 1 || d_scale > D || (long long)B * 2 > 65535)
    return (int)cudaErrorInvalidValue;
#define HVD_PREFILL(DS, FN)                                                 \
  case DS:                                                                  \
    return (int)(D == DS ? FN<DS, false>(HVD_PREFILL_ARGS)                  \
                         : FN<DS, true>(HVD_PREFILL_ARGS));
#define HVD_PREFILL_ARGS \
  q, pool_k, pool_v, tables, positions, out, B, n_t, H, KV, D, d_scale,  \
      BS, nblk, s
  if (dtype == 1) {
    switch (stored_dim(D)) {
      HVD_PREFILL(16, prefill_bf16_d)
      HVD_PREFILL(32, prefill_bf16_d)
      HVD_PREFILL(64, prefill_bf16_d)
      HVD_PREFILL(128, prefill_bf16_d)
      case 256:
        if (D > kWideD)
          return (int)(D == 2 * kWideD
                           ? prefill_bf16_d<256, false, 2>(HVD_PREFILL_ARGS)
                           : prefill_bf16_d<256, true, 2>(HVD_PREFILL_ARGS));
        return (int)(D == kWideD
                         ? prefill_bf16_d<256, false>(HVD_PREFILL_ARGS)
                         : prefill_bf16_d<256, true>(HVD_PREFILL_ARGS));
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (stored_dim(D)) {
    HVD_PREFILL(16, prefill_f32_d)
    HVD_PREFILL(32, prefill_f32_d)
    HVD_PREFILL(64, prefill_f32_d)
    HVD_PREFILL(128, prefill_f32_d)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HVD_PREFILL_ARGS
#undef HVD_PREFILL
}

// The fp32 design for head dims 136 .. 512 (multiples of 8), any T:
// partials over n_split ranges of keys_per_split keys (a multiple of BS)
// for each 16-row tile and 256-column part, then the combine. ws: B * KV
// * n_split * T * (H / KV) * (D + 2) floats.
extern "C" int hvd_paged_attention_wide(
    const void* q, const void* pool_k, const void* pool_v, const int* tables,
    const int* positions, void* out, float* ws, int B, int n_t, int H,
    int KV, int D, int d_scale, int BS, int nblk, int n_split,
    int keys_per_split, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV || n_split <= 0 || keys_per_split <= 0 ||
      keys_per_split % BS || D <= 128 || D > 2 * kWideD || D % 8 ||
      d_scale < 1 || d_scale > D || dtype != 0 ||
      (long long)B * KV * 2 > 65535 ||
      (n_t * (H / KV) + kWideRows - 1) / kWideRows > 65535)
    return (int)cudaErrorInvalidValue;
#define HVD_WIDE_ARGS                                                      \
  q, pool_k, pool_v, tables, positions, out, ws, B, n_t, H, KV, D,        \
      d_scale, BS, nblk, n_split, keys_per_split, s
  if (D > kWideD)
    return (int)(D == 2 * kWideD ? wide_d<false, 2>(HVD_WIDE_ARGS)
                                 : wide_d<true, 2>(HVD_WIDE_ARGS));
  return (int)(D == kWideD ? wide_d<false, 1>(HVD_WIDE_ARGS)
                           : wide_d<true, 1>(HVD_WIDE_ARGS));
#undef HVD_WIDE_ARGS
}
