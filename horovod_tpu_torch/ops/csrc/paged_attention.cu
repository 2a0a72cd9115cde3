// Paged attention over a block-table KV pool, written by hand for Hopper
// (sm_90a).
//
// Replaces horovod_tpu/ops/pallas_paged.py:_paged_attn_kernel (the Pallas
// kernel behind paged_attention_fused). Same function: for each batch row
// b and kv head h, the T*G queries of that row (T positions x G grouped
// query heads) attend over the row's cached keys, gathered through its
// block table, with key j valid for query position t iff j <= pos[b] + t.
// Scores, softmax and the value sum are fp32 whatever the storage type;
// the output is written in q's type.
//
// What bounds it on this card: the KV bytes read. Decode (T = 1) does
// 4 * G * D flops per cached key and reads 4 * D bytes of bf16 K/V for
// it, about 2*G flops per byte: far below the H100's ~295 flops/byte
// ridge, so the floor is (KV bytes read) / 3.35 TB/s. Prefill at
// T = bucket reuses each staged key for up to QT query rows.
//
// What the design does about it:
//   * KV is streamed, never held: the TPU kernel copies a whole
//     [nblk * BS, D] row into VMEM (256 KB of K alone at 2048 x 64 bf16,
//     over the 227 KB a block may use here). This kernel stages 32 keys
//     at a time into shared memory as fp32 with 16-byte loads and keeps
//     an online (running max / running sum) softmax per query row.
//   * One K/V fetch serves every query of the GQA group and every
//     position of the tile: grid (tiles of QT query rows, KV, B), so a
//     (row, kv head) pair with thousands of prefill rows is split over
//     many blocks instead of being serialised in one.
//   * Keys past a tile's last valid position are never read; unassigned
//     (-1) table entries are never read either.
//   * Masked keys are skipped outright, not multiplied by zero: a stale
//     pool byte may be a NaN pattern, and 0 * NaN would poison the sum.
// Not done yet (later work): splitting a long row's keys over several
// blocks for decode at small batch, tensor-core (wgmma) products, TMA.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
// Binding: ctypes, see horovod_tpu_torch/ops/paged.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;  // keys staged per pass: one per lane

__device__ __forceinline__ void unpack(const float4& v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void unpack(const uint4& v, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// 16-byte vector type of each storage type
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
};

template <typename T>
__device__ __forceinline__ void load_row(const T* src, float* dst) {
  using V = typename Vec<T>::type;
  unpack(*reinterpret_cast<const V*>(src), dst);
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

// One block: QT query rows (row r = t * G + g) of one (batch row, kv head).
// Warp w owns rows w, w + 4, w + 8, ...; lane i scores staged key i and
// accumulates output dims i, i + 32, ...
template <typename T, int D, int QT>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                      const T* __restrict__ pool_v,
                      const int* __restrict__ tables,
                      const int* __restrict__ positions, T* __restrict__ out,
                      int n_t, int H, int KV, int BS, int nblk) {
  constexpr int kDimsPerLane = D / 32;
  constexpr int kRowsPerWarp = QT / kWarps;
  constexpr int VN = Vec<T>::n;
  constexpr int kVecPerRow = D / VN;

  __shared__ float q_s[QT][D];
  __shared__ float k_s[kChunk][D + 1];  // +1: lane-strided reads hit
                                        // distinct banks
  __shared__ float v_s[kChunk][D];
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

  // stage the tile's queries as fp32
  for (int i = threadIdx.x; i < QT * kVecPerRow; i += kThreads) {
    const int rl = i / kVecPerRow;
    const int c = i % kVecPerRow;
    const int r = r0 + rl;
    float tmp[VN];
    if (r < rows) {
      const int t = r / G;
      const int g = r % G;
      load_row(q + (((size_t)b * n_t + t) * H + kvh * G + g) * D + c * VN,
               tmp);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) q_s[rl][c * VN + e] = tmp[e];
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
  const float scale_div = sqrtf((float)D);

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
      float tk[VN];
      float tv[VN];
      if (blk >= 0) {
        const int j = c0 + jl;
        const size_t off =
            (((size_t)blk * BS + j % BS) * KV + kvh) * D + c * VN;
        load_row(pool_k + off, tk);
        load_row(pool_v + off, tv);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          tk[e] = 0.f;
          tv[e] = 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        k_s[jl][c * VN + e] = tk[e];
        v_s[jl][c * VN + e] = tv[e];
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
        for (int d = 0; d < D; ++d) s += q_s[rl][d] * k_s[lane][d];
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
              acc[i][k] += pj * v_s[jj][lane + 32 * k];
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
      T* dst = out + (((size_t)b * n_t + t) * H + kvh * G + g) * D;
#pragma unroll
      for (int k = 0; k < kDimsPerLane; ++k)
        store(acc[i][k] * inv, dst + lane + 32 * k);
    }
  }
}

template <typename T, int D, int QT>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const int* tables, const int* positions, void* out, int B,
                   int n_t, int H, int KV, int BS, int nblk,
                   cudaStream_t stream) {
  const int rows = n_t * (H / KV);
  dim3 grid((rows + QT - 1) / QT, KV, B);
  paged_attn_kernel<T, D, QT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), tables, positions, static_cast<T*>(out),
      n_t, H, KV, BS, nblk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* pool_k,
                         const void* pool_v, const int* tables,
                         const int* positions, void* out, int B, int n_t,
                         int H, int KV, int D, int BS, int nblk,
                         cudaStream_t stream) {
  // QT keeps the static shared memory under 48 KB
  switch (D) {
    case 32:
      return launch<T, 32, 64>(q, pool_k, pool_v, tables, positions, out, B,
                               n_t, H, KV, BS, nblk, stream);
    case 64:
      return launch<T, 64, 64>(q, pool_k, pool_v, tables, positions, out, B,
                               n_t, H, KV, BS, nblk, stream);
    case 128:
      return launch<T, 128, 16>(q, pool_k, pool_v, tables, positions, out,
                                B, n_t, H, KV, BS, nblk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, T, H, D]; pool_k / pool_v [NB, BS, KV, D] (same type as q);
// tables [B, nblk] int32 (-1 = unassigned); positions [B] int32;
// out [B, T, H, D]. dtype 0 = float32, 1 = bfloat16. Returns the launch's
// cudaError_t (0 on success). All pointers are device pointers, 16-byte
// aligned, contiguous.
extern "C" int hvd_paged_attention(const void* q, const void* pool_k,
                                   const void* pool_v, const int* tables,
                                   const int* positions, void* out, int B,
                                   int n_t, int H, int KV, int D, int BS,
                                   int nblk, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dim<float>(q, pool_k, pool_v, tables, positions,
                                    out, B, n_t, H, KV, D, BS, nblk, s);
  if (dtype == 1)
    return (int)dispatch_dim<__nv_bfloat16>(q, pool_k, pool_v, tables,
                                            positions, out, B, n_t, H, KV, D,
                                            BS, nblk, s);
  return (int)cudaErrorInvalidValue;
}
