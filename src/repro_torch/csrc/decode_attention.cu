// B2: flash-decode, one query token against a ring KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// ::decode_attention_bk (its _kernel), reached from repro.kernels.ops
// .decode_attention; the same masked one-token attention is written out in
// jnp at repro/models/attention.py::decode_attention.  A cache slot counts
// iff cpos >= 0, cpos <= cur and (with a window) cur - cpos < window, so a
// ring that has wrapped needs no special case.  Optional tanh softcap;
// online softmax over cache chunks in f32; q pre-scaled by hd^-0.5 by the
// caller.
//
// What bounds it on the card: bytes.  Each cache entry is read once and used
// for ~4·G flops, far below the ~295 flops per byte where the H100's tensor
// cores would become the limit.  The least time is the K/V cache's size over
// the memory rate.
//
// Design: one CTA per (batch, kv head) walks the whole cache in chunks of
// 128 slots and holds the G query heads of that kv head together, so each
// K/V chunk is read from device memory once for G heads.  A chunk is staged
// in shared memory with coalesced loads; then one thread per slot computes
// the G scores, one warp per head takes the chunk's max and sum, and one
// thread per (head, column) pair accumulates P·V.  m, l and acc stay in
// shared memory and registers across chunks, as the TPU kernel keeps them in
// VMEM across its sequential grid axis.
//
// Known limit: B·K CTAs (40 for 8 slots of smollm-360m with K = 5) on 132
// SMs, each walking its chunks in order, cannot draw the card's full memory
// rate.  Splitting the cache across CTAs with a combine pass (split-K) is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;             // cache slots per chunk, one per thread
constexpr int kMaxPairs = 8;            // (head, column) pairs per thread
constexpr float kNegInf = -1e30f;       // masked score, as in the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
size_t smem_bytes(int G) {
  return sizeof(float) *
         (G * HD + kChunk * (HD + 1) + kChunk * HD + G * kChunk + 3 * G);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ cpos,
              const int* __restrict__ cur, T* __restrict__ out, int C, int H,
              int K, int G, int window, float softcap) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [G][HD]
  float* Ks = qs + G * HD;              // [kChunk][HD + 1]
  float* Vs = Ks + kChunk * (HD + 1);   // [kChunk][HD]
  float* ps = Vs + kChunk * HD;         // [G][kChunk]
  float* m_s = ps + G * kChunk;         // [G]
  float* l_s = m_s + G;                 // [G]
  float* corr_s = l_s + G;              // [G]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int cur_b = cur[b];
  const int npairs = G * HD;

  // q [B, H, hd]: the G heads of kv head kh are contiguous
  const T* qg = q + ((size_t)b * H + kh * G) * HD;
  for (int idx = tid; idx < npairs; idx += kThreads) qs[idx] = to_f32(qg[idx]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();                    // last chunk fully consumed
    for (int idx = tid; idx < kChunk * HD; idx += kThreads) {
      const int c = idx / HD, d = idx % HD;
      const int slot = c0 + c;
      float kx = 0.f, vx = 0.f;
      if (slot < C) {
        const size_t off = ((size_t)(b * C + slot) * K + kh) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[c * (HD + 1) + d] = kx;
      Vs[c * HD + d] = vx;
    }
    __syncthreads();

    // scores: thread tid owns slot c0 + tid
    {
      const int slot = c0 + tid;
      bool ok = false;
      if (slot < C) {
        const int p = cpos[(size_t)b * C + slot];
        ok = p >= 0 && p <= cur_b && (window == 0 || cur_b - p < window);
      }
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d)
          s = fmaf(qs[g * HD + d], Ks[tid * (HD + 1) + d], s);
        if (softcap != 0.f) s = softcap * tanhf(s / softcap);
        // slots past the cache never count; invalid ones count as the
        // reference's -1e30
        ps[g * kChunk + tid] = slot >= C ? -INFINITY : (ok ? s : kNegInf);
      }
    }
    __syncthreads();

    // online softmax, one warp per head
    for (int g = warp; g < G; g += kWarps) {
      float* row = ps + g * kChunk;
      float mx = -INFINITY;
      for (int c = lane; c < kChunk; c += 32) mx = fmaxf(mx, row[c]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < kChunk; c += 32) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P·V: thread owns pairs tid + kThreads·i, pair = g·HD + d
    const int nc = min(kChunk, C - c0);
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int pr = tid + kThreads * i;
      if (pr >= npairs) break;
      const int g = pr / HD, d = pr % HD;
      const float* row = ps + g * kChunk;
      float a = acc[i] * corr_s[g];
#pragma unroll 8
      for (int c = 0; c < nc; ++c) a = fmaf(row[c], Vs[c * HD + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();

  T* o = out + ((size_t)b * H + kh * G) * HD;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int pr = tid + kThreads * i;
    if (pr >= npairs) break;
    store(o + pr, acc[i] / fmaxf(l_s[pr / HD], 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cpos, const int* cur, void* out, int B, int C,
                   int H, int K, int window, float softcap,
                   cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = smem_bytes<HD>(G);
  auto kern = decode_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B * K, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cpos, cur, static_cast<T*>(out), C, H, K, G,
      window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* cpos, const int* cur, void* out, int B,
                        int C, int H, int K, int window, float softcap,
                        cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, cpos, cur, out, B, C, H, K, window, softcap, st);
    case 32: return launch<T, 32>(q, k, v, cpos, cur, out, B, C, H, K, window, softcap, st);
    case 64: return launch<T, 64>(q, k, v, cpos, cur, out, B, C, H, K, window, softcap, st);
    case 128: return launch<T, 128>(q, k, v, cpos, cur, out, B, C, H, K, window, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, out: [B, H, hd]; k, v: [B, C, K, hd]; cpos: [B, C] int32; cur: [B]
// int32; all contiguous, q/k/v/out of one dtype (0 = float32,
// 1 = bfloat16); q pre-scaled by hd^-0.5.  H % K == 0 and
// (H / K)·hd <= 1024.  Launches on `stream` and returns cudaGetLastError().
int repro_decode_attention_fwd(const void* q, const void* k, const void* v,
                               const void* cpos, const void* cur, void* out,
                               int dtype, int B, int C, int H, int K, int hd,
                               int window, float softcap, int device,
                               void* stream) {
  if (K <= 0 || H % K != 0 || (H / K) * hd > kThreads * kMaxPairs || C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cp = static_cast<const int*>(cpos);
  const int* cu = static_cast<const int*>(cur);
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, cp, cu, out, B, C, H, K, window, softcap, st);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, cp, cu, out, B, C, H, K, window, softcap, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
