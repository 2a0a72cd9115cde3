// Fused softmax cross entropy, forward (K2) and backward (K3), written by
// hand for Hopper (sm_90a): one launch each way.
//
// Replaces horovod_tpu/ops/pallas_ce.py:_fwd_kernel (hvd_ce_fwd) and
// horovod_tpu/ops/pallas_ce.py:_bwd_kernel (hvd_ce_bwd), the Pallas pair
// behind fused_softmax_cross_entropy, together with the work around them:
// the mean over rows and its backward. Per row t of logits [T, V] with
// integer label y[t] (int32, or int64 read in place: its low 32 bits, as
// a cast to int32 takes them):
//   forward:  m = max_v x, s = sum_v exp(x - m), lse = m + log(max(s, 1e-20)),
//             loss_t = lse - x[y] (x[y] taken as 0 when y is outside [0, V),
//             so a -1 label gives loss_t = lse); writes lse[t] and the mean
//             loss = (sum_t loss_t) / T as one fp32 value.
//   backward: dlogits = (exp(x - lse) - [v == y]) * (g / T), in x's type,
//             g the mean's cotangent, read from device memory.
// Math is fp32 whatever the storage type (fp32 or bf16).
//
// The mean is summed in a fixed order, with no float atomics: each block
// writes the sum of its rows' losses (its rows in order) to a partials
// array; the block that takes the last ticket of an atomic counter sums
// the partials (each thread a strided run in index order, then a fixed
// shuffle tree) and resets the counter to 0 for the next call. So two
// calls, and the replays of a CUDA graph, give the same bits. The caller
// gives each stream its own counter, and each launch captured into a
// graph one of its own, so launches that may overlap never share one.
//
// What bounds it on this card, and what the design does:
//   * At the ResNet head (128 x 1000 fp32, 512 KB) the device work is a
//     few microseconds: the bound is launch latency and the host. The
//     previous design spent its time in the wrapper and in the launches
//     around the kernels (the label cast, the mean, the mean's backward).
//     Here the label is read as it comes, the mean is fused into the
//     forward and its cotangent into the backward, so one loss is one
//     launch each way; the wrapper checks its inputs once, holds its
//     ctypes functions and reads the raw stream handle (ops/ce.py). What
//     is left on the host is mostly the autograd Function's own cost, the
//     two allocations (the loss; lse with the partials) and the launch. A warp takes a row (8 rows to a block of 256
//     threads), so a 1000-class head spreads over 16 SMs with every lane
//     busy.
//   * At the Llama_1B LM head (8192 x 32000) the floor is bytes over 3.35
//     TB/s: the forward reads the logits once, the backward reads them once
//     more and writes as many. A block of 256 threads takes a row; each
//     thread issues several 16-byte loads before it uses any (K2: eight
//     fp32 or one bf16 chunk, K3: four, the fastest of 1, 2, 4 and 8 in
//     builds timed at the LM head), then folds them into its running
//     (max, sum of exp), rescaled once per chunk. No [T, V] intermediate is
//     written; the backward recomputes exp(x - lse) from the saved lse.
//     Builds of K2 that capped the grid at 1024 blocks looping over their
//     rows, or took a warp a row at this width (8x fewer tickets), were
//     timed too and were not faster: a block's reductions then stop
//     overlapping other blocks' loads. The ticket's tail costs a few
//     microseconds at 8192 blocks.
//   * 16-byte vector loads and stores (4 fp32 or 8 bf16 values a thread),
//     neighbouring threads on neighbouring chunks; a row whose start is not
//     16-byte aligned (V * itemsize not a multiple of 16) takes its first
//     few values and its tail one at a time.
// Not done yet (later work): several rows per warp for tiny V, TMA.
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
// 16-byte loads a thread of K3 issues before it uses any (K2's depend on
// the storage type: Vec<T>::kFwdInFlight)
constexpr int kBwdInFlight = 4;

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
// kFwdInFlight: the 16-byte loads a thread of K2 issues before it uses any;
// eight fp32 chunks (4 exps each), one bf16 chunk (8 exps), the fastest of
// 1, 2, 4 and 8 at the LM head on each type.
template <>
struct Vec<float> {
  static constexpr int N = 4, kFwdInFlight = 8;
  using Raw = float4;
  __device__ static void unpack(const Raw& v, float* out) {
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
  static constexpr int N = 8, kFwdInFlight = 1;
  using Raw = uint4;
  __device__ static void unpack(const Raw& v, float* out) {
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

template <typename T>
__device__ __forceinline__ typename Vec<T>::Raw load_raw(const T* p) {
  return *reinterpret_cast<const typename Vec<T>::Raw*>(p);
}

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The (max, sum of exp) and label logit of one row, reduced over the
// kThreads / ROWS threads that share it (a warp, or the block at ROWS 1);
// the group's first thread holds the result.
template <typename T, int ROWS>
__device__ __forceinline__ void row_stats(const T* row, int y, int V,
                                          bool active, Stats& st, float& ly) {
  constexpr int kGroup = kThreads / ROWS;  // threads per row
  constexpr int N = Vec<T>::N;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gtid = threadIdx.x % kGroup;
  st = {-INFINITY, 0.f};
  ly = 0.f;
  if (active) {
    const int pre = head_len(row, V);
    const int nvec = (V - pre) / N;
    for (int i = gtid; i < pre; i += kGroup) {
      const float x = to_float(row[i]);
      add_one(st, x);
      if (i == y) ly = x;
    }
    const T* body = row + pre;
    constexpr int F = Vec<T>::kFwdInFlight;
    for (int j0 = gtid; j0 < nvec; j0 += F * kGroup) {
      typename Vec<T>::Raw raw[F];
#pragma unroll
      for (int u = 0; u < F; ++u) {
        const int j = j0 + u * kGroup;
        if (j < nvec) raw[u] = load_raw(body + j * N);
      }
#pragma unroll
      for (int u = 0; u < F; ++u) {
        const int j = j0 + u * kGroup;
        if (j >= nvec) break;
        float x[N];
        Vec<T>::unpack(raw[u], x);
        add_chunk<N>(st, x);
        const int k = y - (pre + j * N);
        if (k >= 0 && k < N) {
#pragma unroll
          for (int i = 0; i < N; ++i)
            if (i == k) ly = x[i];
        }
      }
    }
    for (int i = pre + nvec * N + gtid; i < V; i += kGroup) {
      const float x = to_float(row[i]);
      add_one(st, x);
      if (i == y) ly = x;
    }
  }
  warp_reduce(st, ly);
  if (ROWS == 1) {
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
}

// ROWS = kWarps: one warp per row; 1: the whole block per row. The
// block's partial is its rows' losses summed in row order.
template <typename T, typename L, int ROWS>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                  float* __restrict__ loss, float* __restrict__ lse,
                  float* __restrict__ partials, unsigned* __restrict__ ticket,
                  int n_rows, int V) {
  constexpr int kGroup = kThreads / ROWS;  // threads per row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * ROWS + (ROWS == 1 ? 0 : warp);
  const bool active = r < n_rows;
  __shared__ float s_loss[kWarps];
  __shared__ bool s_last;
  Stats st;
  float ly;
  // an int64 label: its low 32 bits
  row_stats<T, ROWS>(logits + (active ? r : 0) * (long long)V,
                     active ? (int)labels[r] : -1, V, active, st, ly);
  if (threadIdx.x % kGroup == 0) {
    float row_loss = 0.f;
    if (active) {
      const float l = st.m + logf(fmaxf(st.s, 1e-20f));
      lse[r] = l;
      row_loss = l - ly;
    }
    s_loss[threadIdx.x / kGroup] = row_loss;
  }
  __syncthreads();
  // the block's partial, then the ticket
  if (threadIdx.x == 0) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) part += s_loss[i];
    partials[blockIdx.x] = part;
    __threadfence();  // the partial is visible before the ticket is taken
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: every partial has landed; sum them in a fixed order
  __threadfence();
  float acc = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads)
    acc += __ldcg(partials + i);
  acc = warp_sum(acc);
  if (lane == 0) s_loss[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_loss[w];
    *loss = total / (float)n_rows;
    *ticket = 0u;  // ready for the next call (or graph replay)
  }
}

template <typename T, typename L, int ROWS>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  T* __restrict__ dlogits, int n_rows, int V) {
  constexpr int kGroup = kThreads / ROWS;
  constexpr int N = Vec<T>::N;
  const int gtid = threadIdx.x % kGroup;
  const long long r = (long long)blockIdx.x * ROWS +
                      (ROWS == 1 ? 0 : threadIdx.x / 32);
  if (r >= n_rows) return;
  const T* row = logits + r * (long long)V;
  T* drow = dlogits + r * (long long)V;
  const int y = (int)labels[r];
  const float l = lse[r];
  const float gr = __ldg(g) / (float)n_rows;  // the mean's cotangent a row
  // logits and dlogits share their layout and 16-byte base alignment, so
  // one head length serves both rows
  const int pre = head_len(row, V);
  const int nvec = (V - pre) / N;
  for (int i = gtid; i < pre; i += kGroup) {
    const float p = expf(to_float(row[i]) - l);
    from_float((p - (i == y ? 1.f : 0.f)) * gr, drow + i);
  }
  for (int j0 = gtid; j0 < nvec; j0 += kBwdInFlight * kGroup) {
    typename Vec<T>::Raw raw[kBwdInFlight];
#pragma unroll
    for (int u = 0; u < kBwdInFlight; ++u) {
      const int j = j0 + u * kGroup;
      if (j < nvec) raw[u] = load_raw(row + pre + j * N);
    }
#pragma unroll
    for (int u = 0; u < kBwdInFlight; ++u) {
      const int j = j0 + u * kGroup;
      if (j >= nvec) break;
      const int base = pre + j * N;
      float x[N];
      Vec<T>::unpack(raw[u], x);
#pragma unroll
      for (int i = 0; i < N; ++i)
        x[i] = (expf(x[i] - l) - (base + i == y ? 1.f : 0.f)) * gr;
      Vec<T>::store(x, drow + base);
    }
  }
  for (int i = pre + nvec * N + gtid; i < V; i += kGroup) {
    const float p = expf(to_float(row[i]) - l);
    from_float((p - (i == y ? 1.f : 0.f)) * gr, drow + i);
  }
}

// Blocks of a launch: 8 rows to a block at V <= kWarpRowMaxV, else one.
int n_blocks(int T_rows, int V) {
  return V <= kWarpRowMaxV ? (T_rows + kWarps - 1) / kWarps : T_rows;
}

template <typename T, typename L>
cudaError_t fwd(const void* logits, const void* labels, float* loss,
                float* lse, unsigned* ticket, int T_rows, int V,
                cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  const L* y = static_cast<const L*>(labels);
  float* partials = lse + T_rows;
  const int blocks = n_blocks(T_rows, V);
  if (V <= kWarpRowMaxV)
    ce_fwd_kernel<T, L, kWarps><<<blocks, kThreads, 0, s>>>(
        x, y, loss, lse, partials, ticket, T_rows, V);
  else
    ce_fwd_kernel<T, L, 1><<<blocks, kThreads, 0, s>>>(
        x, y, loss, lse, partials, ticket, T_rows, V);
  return cudaGetLastError();
}

template <typename T, typename L>
cudaError_t bwd(const void* logits, const void* labels, const float* lse,
                const float* g, void* dlogits, int T_rows, int V,
                cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  const L* y = static_cast<const L*>(labels);
  T* d = static_cast<T*>(dlogits);
  const int blocks = n_blocks(T_rows, V);
  if (V <= kWarpRowMaxV)
    ce_bwd_kernel<T, L, kWarps><<<blocks, kThreads, 0, s>>>(x, y, lse, g, d,
                                                            T_rows, V);
  else
    ce_bwd_kernel<T, L, 1><<<blocks, kThreads, 0, s>>>(x, y, lse, g, d,
                                                       T_rows, V);
  return cudaGetLastError();
}

// Makes `device` current for the launch when it is not already, and puts
// the previous one back after.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// logits [T, V] contiguous (fp32: dtype 0, bf16: 1); labels [T] int32
// (label64 0) or int64 (1); loss: the mean loss, one fp32 value; lse:
// lse [T], then n_blocks partials, fp32; ticket: one unsigned int that is
// 0 between calls (the launch leaves it 0). nb must equal the launch's
// block count (the caller sizes `lse` with it). Launches on `stream` of
// `device`.
// Returns the launch's cudaError_t (0 on success).
extern "C" int hvd_ce_fwd(const void* logits, const void* labels, int label64,
                          float* loss, float* lse, unsigned* ticket,
                          int T_rows, int V, int nb, int dtype, int device,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0 || V <= 0 || nb != n_blocks(T_rows, V))
    return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (dtype == 0 && label64 == 0)
    return (int)fwd<float, int>(logits, labels, loss, lse, ticket, T_rows,
                                V, s);
  if (dtype == 0 && label64 == 1)
    return (int)fwd<float, long long>(logits, labels, loss, lse, ticket,
                                      T_rows, V, s);
  if (dtype == 1 && label64 == 0)
    return (int)fwd<__nv_bfloat16, int>(logits, labels, loss, lse, ticket,
                                        T_rows, V, s);
  if (dtype == 1 && label64 == 1)
    return (int)fwd<__nv_bfloat16, long long>(logits, labels, loss, lse,
                                              ticket, T_rows, V, s);
  return (int)cudaErrorInvalidValue;
}

// logits, dlogits [T, V] contiguous, same dtype, 16-byte aligned bases;
// labels as above; lse [T] fp32; g the mean's cotangent, one fp32 value.
extern "C" int hvd_ce_bwd(const void* logits, const void* labels, int label64,
                          const float* lse, const float* g, void* dlogits,
                          int T_rows, int V, int dtype, int device,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T_rows <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (dtype == 0 && label64 == 0)
    return (int)bwd<float, int>(logits, labels, lse, g, dlogits, T_rows, V, s);
  if (dtype == 0 && label64 == 1)
    return (int)bwd<float, long long>(logits, labels, lse, g, dlogits, T_rows,
                                      V, s);
  if (dtype == 1 && label64 == 0)
    return (int)bwd<__nv_bfloat16, int>(logits, labels, lse, g, dlogits,
                                        T_rows, V, s);
  if (dtype == 1 && label64 == 1)
    return (int)bwd<__nv_bfloat16, long long>(logits, labels, lse, g, dlogits,
                                              T_rows, V, s);
  return (int)cudaErrorInvalidValue;
}
