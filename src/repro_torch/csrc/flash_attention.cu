// B1: flash attention forward (train / prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// ::flash_attention_bkgs (its _kernel), reached from repro.kernels.ops
// .flash_attention.  It computes the same function: blocked online-softmax
// attention with GQA, an optional causal mask and sliding window on absolute
// indices, an optional tanh softcap, f32 accumulation, q pre-scaled by
// hd^-0.5 by the caller.
//
// What bounds it on the card: at the prefill shapes of the models the port
// runs (S ~ 1k, hd = 64) attention does ~hd/2 operations per byte it must
// read, so with tensor cores it would be bound by operations.  This first
// kernel uses plain f32 FMA, not the tensor cores, so it is bound by the FMA
// rate and, below that, by shared-memory bandwidth (two shared loads per
// two FMAs).  Tensor cores (mma.sync / wgmma) and TMA are later work.
//
// Design, rethought for the GPU rather than copied block by block:
//  * The TPU grid walks kv blocks in order on one core and carries m, l,
//    acc in VMEM between grid steps.  Here one CTA owns one
//    (batch*kv-head, q-tile) and loops over the K/V tiles itself, keeping
//    m, l and acc in registers.
//  * The CTA holds all G query heads that share its kv head: its 64 rows
//    are (query, head) pairs, row = qi*G + g, so each K/V tile is loaded
//    into shared memory once for G heads.  bq = 64 / G queries per CTA
//    (21 for smollm's G = 3).
//  * Tiles outside the causal / window band are never visited: the loop
//    bounds come from the tile's first and last query.  The Pallas kernel
//    visits every grid point and skips dead blocks with pl.when.
//  * Ragged edges are masked here (queries >= S, keys >= T), so S and T
//    need not be multiples of a block; the Pallas kernel halves its block
//    until it divides S and falls to bq = 1 for a prime S.
//  * It reads and writes the model's layouts directly: q/out [B,S,H,hd],
//    k/v [B,T,K,hd]; no transposes around the call.
//
// Threads: 256 as 16 x 16.  Thread (ty, tx) owns rows ty + 16i (i < 4), score
// columns tx + 16j (j < 4) and output columns tx + 16e (e < hd/16).  A row's
// 16 owners are one half-warp, so row max and sum are xor shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;               // (query, head) rows per CTA
constexpr int kBkv = 64;                // keys per tile
constexpr int kRowPad = kRows + 2;      // stride of Qs / Ps: conflict-free
constexpr int kKeyPad = kBkv + 1;       // stride of Ks (transposed)
constexpr float kNegInf = -1e30f;       // masked score, as in the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (HD * kRowPad + HD * kKeyPad + kBkv * HD + kBkv * kRowPad);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
                 int H, int K, int G, int bq, int causal, int window,
                 float softcap) {
  constexpr int E = HD / 16;            // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // [HD][kRowPad]
  float* Ks = Qs + HD * kRowPad;        // [HD][kKeyPad]
  float* Vs = Ks + HD * kKeyPad;        // [kBkv][HD]
  float* Ps = Vs + kBkv * HD;           // [kBkv][kRowPad]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int q0 = blockIdx.x * bq;
  const int nrows = G * bq;

  // Q tile, transposed; padding rows are zero.
  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = q0 + r / G;
    float x = 0.f;
    if (r < nrows && s < S)
      x = to_f32(q[((size_t)(b * S + s) * H + kh * G + r % G) * HD + d]);
    Qs[d * kRowPad + r] = x;
  }

  // Keys this tile of queries can see.
  const int q_hi = min(q0 + bq, S) - 1;
  const int t_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_end = causal ? min(Tk, q_hi + 1) : Tk;

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = q0 + (ty + 16 * i) / G;

  float m[4], l[4], acc[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += kBkv) {
    __syncthreads();                    // last tile's Ks / Vs / Ps are read
    for (int idx = tid; idx < kBkv * HD; idx += kThreads) {
      const int c = idx / HD, d = idx % HD;
      const int t = t0 + c;
      float kx = 0.f, vx = 0.f;
      if (t < t_end) {
        const size_t off = ((size_t)(b * Tk + t) * K + kh) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[d * kKeyPad + c] = kx;
      Vs[c * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[d * kRowPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[d * kKeyPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pk = t0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        bool ok = true;
        if (causal) ok = ok && pk <= qpos[i];
        if (window) ok = ok && qpos[i] - pk < window;
        // keys past the tile's end never count; masked keys count as the
        // reference's -1e30, so a row's online softmax matches it exactly
        s[i][j] = pk >= t_end ? -INFINITY : (ok ? x : kNegInf);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(tx + 16 * j) * kRowPad + ty + 16 * i] = p;
      }
      sum = half_warp_sum(sum);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

    const int nc = min(kBkv, t_end - t0);
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      float pv[4], vv[E];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[c * kRowPad + ty + 16 * i];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = Vs[c * HD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int s = q0 + r / G;
    if (r >= nrows || s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((size_t)(b * S + s) * H + kh * G + r % G) * HD;
#pragma unroll
    for (int e = 0; e < E; ++e) store(o + tx + 16 * e, acc[i][e] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Tk, int H, int K, int causal, int window,
                   float softcap, cudaStream_t stream) {
  const int G = H / K;
  const int bq = kRows / G;
  const size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + bq - 1) / bq, B * K);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, K, G, bq,
      causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, int B, int S, int Tk, int H, int K,
                        int causal, int window, float softcap,
                        cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, Tk, H, K, causal, window, softcap, st);
    case 32: return launch<T, 32>(q, k, v, out, B, S, Tk, H, K, causal, window, softcap, st);
    case 64: return launch<T, 64>(q, k, v, out, B, S, Tk, H, K, causal, window, softcap, st);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Tk, H, K, causal, window, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, out: [B, S, H, hd]; k, v: [B, T, K, hd]; all contiguous, one dtype
// (0 = float32, 1 = bfloat16); q pre-scaled by hd^-0.5.  H % K == 0 and
// H / K <= 64.  Launches on `stream` and returns cudaGetLastError().
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* out, int dtype, int B, int S, int T,
                              int H, int K, int hd, int causal, int window,
                              float softcap, int device, void* stream) {
  if (K <= 0 || H % K != 0 || H / K > kRows || S <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, out, B, S, T, H, K, causal, window, softcap, st);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, T, H, K, causal, window, softcap, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
