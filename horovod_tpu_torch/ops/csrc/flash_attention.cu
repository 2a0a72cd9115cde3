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
// What the design does about it:
//   * bf16 tensors run on the tensor cores through mma.sync m16n8k16 (bf16
//     products, fp32 accumulation), FlashAttention-2's warp layout: a block
//     of 4 warps owns 64 query rows (K4, K5) or 64 keys (K6), 16 per warp,
//     and walks the other side in tiles of 64 staged in shared memory. The
//     score tile never leaves registers: its accumulator fragments are
//     repacked in place as the A operand of the next product (p v, ds k).
//   * The softmax statistics, lse, delta and every accumulator are fp32.
//   * Causal blocks stop at the diagonal (K4, K5) or start there (K6), and
//     only tiles that straddle a bound compute the mask. K4 launches the
//     heaviest query tiles first.
//   * K6 sums the group's query heads in registers and writes dk and dv
//     once: no atomics, so a step is deterministic.
//   * fp32 tensors are computed in fp32 on the CUDA cores (four threads per
//     row, each owning every fourth element of the head dim), as the TPU
//     kernel upcasts everything: these kernels serve the fp32 parity runs,
//     not the bf16 training path.
// Not done yet (later work): wgmma and TMA, cp.async double buffering of the
// tiles, ldmatrix fragment loads, a persistent schedule.
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
constexpr int kMmaThreads = 128;   // 4 warps x 16 rows
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
  long long qs[3], ks[3], vs[3], dos[3], o0s[3], o1s[3];  // b, h, row
  int B, H, KV, G, Sq, Skv;
  float scale;
  int causal;
};

__device__ __forceinline__ bool masked(const Params& p, int qpos, int kpos) {
  return (p.causal && kpos > qpos) || kpos >= p.Skv || qpos >= p.Sq;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
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

// kTile rows of D bf16 from global (row stride rs, first `valid` rows real)
// into shared memory with row stride LD; rows past `valid` are zeros.
template <int D, int LD>
__device__ __forceinline__ void load_tile(uint16_t* sm, const uint16_t* g,
                                          long long rs, int valid) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < kTile * kVecs; i += blockDim.x) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(g + r * rs + c);
    *reinterpret_cast<uint4*>(sm + r * LD + c) = val;
  }
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

// acc[j] (16 x 8, j over n tiles) += A(16 x D at rows r0 of sa) * B^T where
// B is the [n][D] tile sb: the score-shaped product q k^T.
template <int D, int LD, int N>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const uint16_t* sa,
                                        const uint16_t* sb, int r0,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a<LD>(a, sa, r0, kk * 16, lane);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      uint32_t b[2];
      frag_b_nk<LD>(b, sb, j * 8, kk * 16, lane);
      mma_bf16(acc[j], a, b);
    }
  }
}

// acc[jd] (16 x 8, jd over D / 8) += P * B where P (16 x 64) sits in score
// fragments s[8][4] and B is the [64][D] tile sb: the products p v, ds k.
template <int D, int LD>
__device__ __forceinline__ void mma_pb(float (*acc)[4], const float (*s)[4],
                                       const uint16_t* sb, int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      uint32_t b[2];
      frag_b_kn<LD>(b, sb, kk * 16, jd * 8, lane);
      mma_bf16(acc[jd], a, b);
    }
  }
}

// Rows g and g + 8 of a warp's 16 x D accumulator, times `mul[r]`, as bf16
// at out + row * rs (row r of the two below `rows[r]`, skipped past `n`).
template <int D>
__device__ __forceinline__ void store_rows(uint16_t* out, long long rs,
                                           const float (*acc)[4],
                                           const int* rows, const float* mul,
                                           int n, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= n) continue;
    uint16_t* o = out + rows[r] * rs + 2 * (lane & 3);
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
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

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
fwd_bf16(Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;
  uint16_t* sK = sQ + kTile * LD;
  uint16_t* sV = sK + kTile * LD;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const uint16_t* kg = (const uint16_t*)p.k + b * p.ks[0] + kvh * p.ks[1];
  const uint16_t* vg = (const uint16_t*)p.v + b * p.vs[0] + kvh * p.vs[1];
  load_tile<D, LD>(sQ,
                   (const uint16_t*)p.q + b * p.qs[0] + h * p.qs[1] +
                       q0 * p.qs[2],
                   p.qs[2], p.Sq - q0);
  const int nk = p.causal ? min(p.Skv, q0 + kTile) : p.Skv;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();
    load_tile<D, LD>(sK, kg + k0 * p.ks[2], p.ks[2], p.Skv - k0);
    load_tile<D, LD>(sV, vg + k0 * p.vs[2], p.vs[2], p.Skv - k0);
    __syncthreads();
    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt<D, LD, kTile>(s, sQ, sK, warp * 16, lane);
    const bool edge = (p.causal && k0 + kTile - 1 > q0) || k0 + kTile > p.Skv;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (edge && masked(p, rows[e >> 1], k0 + j * 8 + 2 * t + (e & 1)))
          x = kNegInf;
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
      for (int jd = 0; jd < D / 8; ++jd) {
        o[jd][2 * r] *= corr;
        o[jd][2 * r + 1] *= corr;
      }
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pe = x <= kMaskedBelow ? 0.f : __expf(x - safe[e >> 1]);
        s[j][e] = pe;
        l[e >> 1] += pe;
      }
    mma_pb<D, LD>(o, s, sV, lane);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(l[r], 1e-20f);
  }
  store_rows<D>((uint16_t*)p.out0 + b * p.o0s[0] + h * p.o0s[1], p.o0s[2], o,
                rows, inv, p.Sq, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < p.Sq) {
        const float sm = m[r] <= kMaskedBelow ? 0.f : m[r];
        p.lse[((long long)b * p.H + h) * p.Sq + rows[r]] =
            sm + logf(fmaxf(l[r], 1e-20f));
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dq_bf16(Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;
  uint16_t* sDO = sQ + kTile * LD;
  uint16_t* sK = sDO + kTile * LD;
  uint16_t* sV = sK + kTile * LD;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const uint16_t* kg = (const uint16_t*)p.k + b * p.ks[0] + kvh * p.ks[1];
  const uint16_t* vg = (const uint16_t*)p.v + b * p.vs[0] + kvh * p.vs[1];
  load_tile<D, LD>(sQ,
                   (const uint16_t*)p.q + b * p.qs[0] + h * p.qs[1] +
                       q0 * p.qs[2],
                   p.qs[2], p.Sq - q0);
  load_tile<D, LD>(sDO,
                   (const uint16_t*)p.dout + b * p.dos[0] + h * p.dos[1] +
                       q0 * p.dos[2],
                   p.dos[2], p.Sq - q0);
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = ((long long)b * p.H + h) * p.Sq + rows[r];
    lse[r] = rows[r] < p.Sq ? p.lse_in[i] : 0.f;
    delta[r] = rows[r] < p.Sq ? p.delta[i] : 0.f;
  }
  const int nk = p.causal ? min(p.Skv, q0 + kTile) : p.Skv;
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kTile) {
    __syncthreads();
    load_tile<D, LD>(sK, kg + k0 * p.ks[2], p.ks[2], p.Skv - k0);
    load_tile<D, LD>(sV, vg + k0 * p.vs[2], p.vs[2], p.Skv - k0);
    __syncthreads();
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<D, LD, kTile>(s, sQ, sK, warp * 16, lane);
    mma_abt<D, LD, kTile>(dp, sDO, sV, warp * 16, lane);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool off = masked(p, rows[r], k0 + j * 8 + 2 * t + (e & 1));
        const float pe = off ? 0.f : __expf(s[j][e] * p.scale - lse[r]);
        s[j][e] = pe * (dp[j][e] - delta[r]);
      }
    mma_pb<D, LD>(dq, s, sK, lane);
  }
  const float mul[2] = {p.scale, p.scale};
  store_rows<D>((uint16_t*)p.out0 + b * p.o0s[0] + h * p.o0s[1], p.o0s[2],
                dq, rows, mul, p.Sq, lane);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dkv_bf16(Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sK = smem;
  uint16_t* sV = sK + kTile * LD;
  uint16_t* sQ = sV + kTile * LD;
  uint16_t* sDO = sQ + kTile * LD;
  float* sL = reinterpret_cast<float*>(sDO + kTile * LD);
  float* sDelta = sL + kTile;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTile;
  load_tile<D, LD>(sK,
                   (const uint16_t*)p.k + b * p.ks[0] + kvh * p.ks[1] +
                       k0 * p.ks[2],
                   p.ks[2], p.Skv - k0);
  load_tile<D, LD>(sV,
                   (const uint16_t*)p.v + b * p.vs[0] + kvh * p.vs[1] +
                       k0 * p.vs[2],
                   p.vs[2], p.Skv - k0);
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  // the first query that sees key k0 is k0 itself (causal)
  const int qstart = p.causal ? k0 : 0;

  for (int gi = 0; gi < p.G; ++gi) {
    const int h = kvh * p.G + gi;
    const uint16_t* qg = (const uint16_t*)p.q + b * p.qs[0] + h * p.qs[1];
    const uint16_t* dg =
        (const uint16_t*)p.dout + b * p.dos[0] + h * p.dos[1];
    const long long row0 = ((long long)b * p.H + h) * p.Sq;
    for (int q0 = qstart; q0 < p.Sq; q0 += kTile) {
      __syncthreads();
      load_tile<D, LD>(sQ, qg + q0 * p.qs[2], p.qs[2], p.Sq - q0);
      load_tile<D, LD>(sDO, dg + q0 * p.dos[2], p.dos[2], p.Sq - q0);
      for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        const bool in = q0 + i < p.Sq;
        sL[i] = in ? p.lse_in[row0 + q0 + i] : 0.f;
        sDelta[i] = in ? p.delta[row0 + q0 + i] : 0.f;
      }
      __syncthreads();
      // transposed scores: rows are this warp's 16 keys, columns queries
      float st[kTile / 8][4], dpt[kTile / 8][4];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      mma_abt<D, LD, kTile>(st, sK, sQ, warp * 16, lane);
      mma_abt<D, LD, kTile>(dpt, sV, sDO, warp * 16, lane);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          const bool off = masked(p, q0 + c, keys[e >> 1]);
          const float pe = off ? 0.f : __expf(st[j][e] * p.scale - sL[c]);
          st[j][e] = pe;
          dpt[j][e] = pe * (dpt[j][e] - sDelta[c]);
        }
      mma_pb<D, LD>(dv, st, sDO, lane);
      mma_pb<D, LD>(dk, dpt, sQ, lane);
    }
  }
  const float one[2] = {1.f, 1.f}, sc[2] = {p.scale, p.scale};
  store_rows<D>((uint16_t*)p.out0 + b * p.o0s[0] + kvh * p.o0s[1], p.o0s[2],
                dk, keys, sc, p.Skv, lane);
  store_rows<D>((uint16_t*)p.out1 + b * p.o1s[0] + kvh * p.o1s[1], p.o1s[2],
                dv, keys, one, p.Skv, lane);
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores: 64 rows per block, 4 threads per row; thread c of
// a row owns elements c, c + 4, c + 8, ... of the head dim
// ---------------------------------------------------------------------------

// kF32Tile rows of D floats into shared memory [row][D]; zeros past `valid`.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* sm, const float* g,
                                              long long rs, int valid,
                                              float mul) {
  for (int i = threadIdx.x; i < kF32Tile * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    sm[i] = r < valid ? g[r * rs + c] * mul : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
fwd_f32(Params p) {
  constexpr int E = D / 4;
  __shared__ float sK[kF32Tile * D], sV[kF32Tile * D];
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
    q[i] = live ? qg[c + 4 * i] * p.scale : 0.f;
    o[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int nk = p.causal ? min(p.Skv, q0 + kTile) : p.Skv;
  for (int k0 = 0; k0 < nk; k0 += kF32Tile) {
    __syncthreads();
    load_rows_f32<D>(sK, kg + k0 * p.ks[2], p.ks[2], p.Skv - k0, 1.f);
    load_rows_f32<D>(sV, vg + k0 * p.vs[2], p.vs[2], p.Skv - k0, 1.f);
    __syncthreads();
    float s[kF32Tile];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) x += q[i] * sK[j * D + c + 4 * i];
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
      for (int i = 0; i < E; ++i) o[i] += pe * sV[j * D + c + 4 * i];
    }
    m = mx;
  }
  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-20f);
  float* og = (float*)p.out0 + b * p.o0s[0] + h * p.o0s[1] +
              (long long)row * p.o0s[2];
#pragma unroll
  for (int i = 0; i < E; ++i) og[c + 4 * i] = o[i] * inv;
  if (c == 0)
    p.lse[((long long)b * p.H + h) * p.Sq + row] =
        (m <= kMaskedBelow ? 0.f : m) + logf(fmaxf(l, 1e-20f));
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
bwd_dq_f32(Params p) {
  constexpr int E = D / 4;
  __shared__ float sK[kF32Tile * D], sV[kF32Tile * D];
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
    q[i] = live ? qg[c + 4 * i] * p.scale : 0.f;
    d[i] = live ? dg[c + 4 * i] : 0.f;
    dq[i] = 0.f;
  }
  const int nk = p.causal ? min(p.Skv, q0 + kTile) : p.Skv;
  for (int k0 = 0; k0 < nk; k0 += kF32Tile) {
    __syncthreads();
    load_rows_f32<D>(sK, kg + k0 * p.ks[2], p.ks[2], p.Skv - k0, 1.f);
    load_rows_f32<D>(sV, vg + k0 * p.vs[2], p.vs[2], p.Skv - k0, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kF32Tile; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        s += q[i] * sK[j * D + c + 4 * i];
        dp += d[i] * sV[j * D + c + 4 * i];
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const float pe = masked(p, row, k0 + j) ? 0.f : expf(s - lse);
      const float ds = pe * (dp - delta);
#pragma unroll
      for (int i = 0; i < E; ++i) dq[i] += ds * sK[j * D + c + 4 * i];
    }
  }
  if (!live) return;
  float* og = (float*)p.out0 + b * p.o0s[0] + h * p.o0s[1] +
              (long long)row * p.o0s[2];
#pragma unroll
  for (int i = 0; i < E; ++i) og[c + 4 * i] = dq[i] * p.scale;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
bwd_dkv_f32(Params p) {
  constexpr int E = D / 4;
  __shared__ float sQ[kF32Tile * D], sDO[kF32Tile * D];
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
    kr[i] = live ? kg[c + 4 * i] : 0.f;
    vr[i] = live ? vg[c + 4 * i] : 0.f;
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
      load_rows_f32<D>(sQ, qg + q0 * p.qs[2], p.qs[2], p.Sq - q0, p.scale);
      load_rows_f32<D>(sDO, dg + q0 * p.dos[2], p.dos[2], p.Sq - q0, 1.f);
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
          s += kr[i] * sQ[j * D + c + 4 * i];
          dp += vr[i] * sDO[j * D + c + 4 * i];
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        const float pe = masked(p, q0 + j, key) ? 0.f : expf(s - sL[j]);
        const float ds = pe * (dp - sDelta[j]);
#pragma unroll
        for (int i = 0; i < E; ++i) {
          dv[i] += pe * sDO[j * D + c + 4 * i];
          dk[i] += ds * sQ[j * D + c + 4 * i];
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
    kout[c + 4 * i] = dk[i];
    vout[c + 4 * i] = dv[i];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
cudaError_t launch_d(Kind kind, const Params& p, int dtype,
                     cudaStream_t stream) {
  constexpr int LD = D + 8;
  const int qtiles = (p.Sq + kTile - 1) / kTile;
  const int ktiles = (p.Skv + kTile - 1) / kTile;
  const dim3 grid(kind == kDkv ? ktiles : qtiles,
                  kind == kDkv ? p.KV : p.H, p.B);
  if (dtype == 0) {
    void (*fn)(Params) = kind == kFwd  ? fwd_f32<D>
                         : kind == kDq ? bwd_dq_f32<D>
                                       : bwd_dkv_f32<D>;
    fn<<<grid, kF32Threads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  void (*fn)(Params) = kind == kFwd  ? fwd_bf16<D>
                       : kind == kDq ? bwd_dq_bf16<D>
                                     : bwd_dkv_bf16<D>;
  const int tiles = kind == kFwd ? 3 : 4;
  const size_t smem = tiles * kTile * LD * sizeof(uint16_t) +
                      (kind == kDkv ? 2 * kTile * sizeof(float) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fn<<<grid, kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// dims: B, H, KV, Sq, Skv, D, then (batch, head, row) strides in elements of
// q, k, v, do, out0, out1 (3 each; unused ones ignored).
int launch(Kind kind, const void* q, const void* k, const void* v,
           const void* dout, const float* lse_in, const float* delta,
           void* out0, void* out1, float* lse, const long long* dims,
           float scale, int causal, int dtype, void* stream) {
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
  p.B = (int)dims[0];
  p.H = (int)dims[1];
  p.KV = (int)dims[2];
  p.Sq = (int)dims[3];
  p.Skv = (int)dims[4];
  const int D = (int)dims[5];
  if (p.KV <= 0 || p.H % p.KV || p.B <= 0 || p.Sq <= 0 || p.Skv <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  p.G = p.H / p.KV;
  long long* dst[6] = {p.qs, p.ks, p.vs, p.dos, p.o0s, p.o1s};
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = dims[6 + 3 * i + j];
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return (int)launch_d<16>(kind, p, dtype, s);
    case 32: return (int)launch_d<32>(kind, p, dtype, s);
    case 64: return (int)launch_d<64>(kind, p, dtype, s);
    case 128: return (int)launch_d<128>(kind, p, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// o and lse [B, H, Sq] (fp32, contiguous) from q, k, v.
int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, const long long* dims, float scale, int causal,
                  int dtype, void* stream) {
  return launch(kFwd, q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse,
                dims, scale, causal, dtype, stream);
}

// dq from q, k, v, do and the forward's lse and delta [B, H, Sq] (fp32).
int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, const long long* dims, float scale,
                     int causal, int dtype, void* stream) {
  return launch(kDq, q, k, v, dout, lse, delta, dq, nullptr, nullptr, dims,
                scale, causal, dtype, stream);
}

// dk and dv from q, k, v, do, lse and delta.
int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, const long long* dims, float scale,
                      int causal, int dtype, void* stream) {
  return launch(kDkv, q, k, v, dout, lse, delta, dk, dv, nullptr, dims,
                scale, causal, dtype, stream);
}

}  // extern "C"
