// Fused softmax cross entropy, forward (K2) and backward (K3), written by
// hand for Hopper (sm_90a).
//
// Replaces horovod_tpu/ops/pallas_ce.py:_fwd_kernel (hvd_ce_fwd) and
// horovod_tpu/ops/pallas_ce.py:_bwd_kernel (hvd_ce_bwd), the Pallas pair
// behind fused_softmax_cross_entropy. Same functions, per row t of
// logits [T, V] with integer label y[t]:
//   forward:  m = max_v x, s = sum_v exp(x - m), lse = m + log(max(s, 1e-20)),
//             loss = lse - x[y] (x[y] taken as 0 when y is outside [0, V),
//             so a -1 label gives loss = lse); writes loss[t] and lse[t].
//   backward: dlogits = (exp(x - lse) - [v == y]) * g[t], in x's type.
// Math is fp32 whatever the storage type (fp32 or bf16).
//
// What bounds it on this card: the bytes of the logits. The forward reads
// T * V values once and does a handful of flops on each (one exp); the
// backward reads them once more and writes as many. At the ResNet head
// (128 x 1000) and the Llama_1B LM head (8192 x 32000, 524 MB in bf16)
// that is well under the H100's ridge, so the floor is (bytes) / 3.35 TB/s.
//
// What the design does about it:
//   * One pass over the row in each direction, no [T, V] intermediate in
//     device memory: the forward keeps a running (max, sum of exp) per
//     thread, rescaled once per 16-byte chunk, and picks the label logit
//     in the same pass; the backward recomputes exp(x - lse) from the
//     saved lse. The TPU kernel holds a [block_t, V] tile in VMEM; here a
//     row streams through registers.
//   * 16-byte vector loads and stores (4 fp32 or 8 bf16 values per
//     thread), neighbouring threads on neighbouring chunks; a row whose
//     start is not 16-byte aligned (V * itemsize not a multiple of 16)
//     takes its first few values and its tail one at a time.
//   * One warp per row when V <= 2048 (8 rows per block of 256 threads),
//     so a 1000-class head does not leave 7 of 8 warps idle; one block of
//     256 threads per row above that. Partial results meet by warp
//     shuffles, then, for a block per row, through shared memory.
// Not done yet (later work): several rows per warp for tiny V, overlap of
// loads through cp.async / TMA, and fusing the mean over T.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libcross_entropy.so cross_entropy.cu
// Binding: ctypes, see horovod_tpu_torch/ops/ce.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRowMaxV = 2048;  // one warp per row up to this width

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// 16 bytes of each storage type: N values
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ static void store(const float* in, float* p) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(const float* in, __nv_bfloat16* p) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

// The values of a row before its first 16-byte boundary.
template <typename T>
__device__ __forceinline__ int head_len(const T* row, int V) {
  const int misalign = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const int pre = misalign ? (16 - misalign) / (int)sizeof(T) : 0;
  return pre < V ? pre : V;
}

// Running (max, sum of exp(x - max)) of one thread.
struct Stats {
  float m;
  float s;
};

__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  const float m = fmaxf(a.m, b.m);
  // a part that saw no value has s == 0 and m == -inf: skip its exp, so
  // -inf - -inf never makes a NaN
  const float sa = a.s > 0.f ? a.s * expf(a.m - m) : 0.f;
  const float sb = b.s > 0.f ? b.s * expf(b.m - m) : 0.f;
  return {m, sa + sb};
}

__device__ __forceinline__ void add_one(Stats& st, float x) {
  if (x > st.m) {
    st.s = (st.s > 0.f ? st.s * expf(st.m - x) : 0.f) + 1.f;
    st.m = x;
  } else if (st.m > -INFINITY) {  // else x == m == -inf: adds exp(-inf) = 0
    st.s += expf(x - st.m);
  }
}

template <int N>
__device__ __forceinline__ void add_chunk(Stats& st, const float* x) {
  float cm = x[0];
#pragma unroll
  for (int i = 1; i < N; ++i) cm = fmaxf(cm, x[i]);
  if (cm > st.m) {
    st.s = st.s > 0.f ? st.s * expf(st.m - cm) : 0.f;
    st.m = cm;
  }
  if (st.m == -INFINITY) return;  // an all -inf chunk adds 0
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) acc += expf(x[i] - st.m);
  st.s += acc;
}

__device__ __forceinline__ void warp_reduce(Stats& st, float& ly) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stats o;
    o.m = __shfl_xor_sync(0xffffffffu, st.m, off);
    o.s = __shfl_xor_sync(0xffffffffu, st.s, off);
    ly += __shfl_xor_sync(0xffffffffu, ly, off);
    st = merge(st, o);
  }
}

// ROWS_PER_BLOCK = kWarps: one warp per row; 1: the whole block per row.
template <typename T, int ROWS_PER_BLOCK>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                  float* __restrict__ loss, float* __restrict__ lse, int n_rows,
                  int V) {
  constexpr int kGroup = kThreads / ROWS_PER_BLOCK;  // threads per row
  constexpr int N = Vec<T>::N;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gtid = threadIdx.x % kGroup;
  const long long r = (long long)blockIdx.x * ROWS_PER_BLOCK +
                      (ROWS_PER_BLOCK == 1 ? 0 : warp);
  const bool active = r < n_rows;

  Stats st = {-INFINITY, 0.f};
  float ly = 0.f;
  if (active) {
    const T* row = logits + r * (long long)V;
    const int y = labels[r];
    const int pre = head_len(row, V);
    const int nvec = (V - pre) / N;
    for (int i = gtid; i < pre; i += kGroup) {
      const float x = to_float(row[i]);
      add_one(st, x);
      if (i == y) ly = x;
    }
    const T* body = row + pre;
    for (int j = gtid; j < nvec; j += kGroup) {
      float x[N];
      Vec<T>::load(body + j * N, x);
      add_chunk<N>(st, x);
      const int k = y - (pre + j * N);
      if (k >= 0 && k < N) {
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (i == k) ly = x[i];
      }
    }
    for (int i = pre + nvec * N + gtid; i < V; i += kGroup) {
      const float x = to_float(row[i]);
      add_one(st, x);
      if (i == y) ly = x;
    }
  }
  warp_reduce(st, ly);
  if (ROWS_PER_BLOCK == 1) {
    __shared__ float sm[kWarps], ss[kWarps], sl[kWarps];
    if (lane == 0) {
      sm[warp] = st.m;
      ss[warp] = st.s;
      sl[warp] = ly;
    }
    __syncthreads();
    if (warp == 0) {
      if (lane < kWarps) {
        st = {sm[lane], ss[lane]};
        ly = sl[lane];
      } else {
        st = {-INFINITY, 0.f};
        ly = 0.f;
      }
      warp_reduce(st, ly);
    }
  }
  if (active && threadIdx.x % kGroup == 0) {
    const float l = st.m + logf(fmaxf(st.s, 1e-20f));
    lse[r] = l;
    loss[r] = l - ly;
  }
}

template <typename T, int ROWS_PER_BLOCK>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  T* __restrict__ dlogits, int n_rows, int V) {
  constexpr int kGroup = kThreads / ROWS_PER_BLOCK;
  constexpr int N = Vec<T>::N;
  const int gtid = threadIdx.x % kGroup;
  const long long r = (long long)blockIdx.x * ROWS_PER_BLOCK +
                      (ROWS_PER_BLOCK == 1 ? 0 : threadIdx.x / 32);
  if (r >= n_rows) return;
  const T* row = logits + r * (long long)V;
  T* drow = dlogits + r * (long long)V;
  const int y = labels[r];
  const float l = lse[r];
  const float gr = g[r];
  // logits and dlogits share their layout and 16-byte base alignment, so
  // one head length serves both rows
  const int pre = head_len(row, V);
  const int nvec = (V - pre) / N;
  for (int i = gtid; i < pre; i += kGroup) {
    const float p = expf(to_float(row[i]) - l);
    from_float((p - (i == y ? 1.f : 0.f)) * gr, drow + i);
  }
  for (int j = gtid; j < nvec; j += kGroup) {
    float x[N];
    const int base = pre + j * N;
    Vec<T>::load(row + base, x);
#pragma unroll
    for (int i = 0; i < N; ++i)
      x[i] = (expf(x[i] - l) - (base + i == y ? 1.f : 0.f)) * gr;
    Vec<T>::store(x, drow + base);
  }
  for (int i = pre + nvec * N + gtid; i < V; i += kGroup) {
    const float p = expf(to_float(row[i]) - l);
    from_float((p - (i == y ? 1.f : 0.f)) * gr, drow + i);
  }
}

template <typename T>
cudaError_t fwd(const void* logits, const int* labels, float* loss,
                float* lse, int T_rows, int V, cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  if (V <= kWarpRowMaxV) {
    const int blocks = (T_rows + kWarps - 1) / kWarps;
    ce_fwd_kernel<T, kWarps><<<blocks, kThreads, 0, s>>>(x, labels, loss, lse,
                                                         T_rows, V);
  } else {
    ce_fwd_kernel<T, 1><<<T_rows, kThreads, 0, s>>>(x, labels, loss, lse,
                                                    T_rows, V);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* logits, const int* labels, const float* lse,
                const float* g, void* dlogits, int T_rows, int V,
                cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  T* d = static_cast<T*>(dlogits);
  if (V <= kWarpRowMaxV) {
    const int blocks = (T_rows + kWarps - 1) / kWarps;
    ce_bwd_kernel<T, kWarps><<<blocks, kThreads, 0, s>>>(x, labels, lse, g, d,
                                                         T_rows, V);
  } else {
    ce_bwd_kernel<T, 1><<<T_rows, kThreads, 0, s>>>(x, labels, lse, g, d,
                                                    T_rows, V);
  }
  return cudaGetLastError();
}

}  // namespace

// logits [T, V] contiguous, 16-byte aligned base; labels [T] int32;
// loss, lse [T] float32. dtype 0 = float32, 1 = bfloat16. Returns the
// launch's cudaError_t (0 on success). Device pointers throughout.
extern "C" int hvd_ce_fwd(const void* logits, const int* labels, float* loss,
                          float* lse, int T_rows, int V, int dtype,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)fwd<float>(logits, labels, loss, lse, T_rows, V, s);
  if (dtype == 1)
    return (int)fwd<__nv_bfloat16>(logits, labels, loss, lse, T_rows, V, s);
  return (int)cudaErrorInvalidValue;
}

// logits, dlogits [T, V] contiguous, same dtype, 16-byte aligned bases;
// labels [T] int32; lse, g [T] float32.
extern "C" int hvd_ce_bwd(const void* logits, const int* labels,
                          const float* lse, const float* g, void* dlogits,
                          int T_rows, int V, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd<float>(logits, labels, lse, g, dlogits, T_rows, V, s);
  if (dtype == 1)
    return (int)bwd<__nv_bfloat16>(logits, labels, lse, g, dlogits, T_rows, V,
                                   s);
  return (int)cudaErrorInvalidValue;
}
