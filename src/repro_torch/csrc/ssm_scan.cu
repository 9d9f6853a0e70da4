// K7: the diagonal linear recurrence, the port of
// src/repro/kernels/ssm_scan.py::ssm_scan (Pallas body `_scan_kernel`).
//
// h_t = a_t * h_{t-1} + b_t from h_{-1} = 0 over a, b (B, T, C), every h_t
// written to hs (B, T, C) and the last to h_final (B, C), all in fp32
// (inputs bf16 or fp32), as the reference computes it.
//
// What bounds it: bytes.  Each step reads a_t and b_t and writes h_t once,
// 3 x 4 bytes per (b, t, c) in fp32: Falcon-Mamba-7B's flattened selective
// scan (C = 8192 x 16, T = 916) moves 1.44 GB, about 0.43 ms at the
// 3.35 TB/s of an NVIDIA H100 SXM (data sheet, 700 W limit); the FMA is
// 2 operations per 12 bytes.
//
// Design: the Pallas grid carries h in VMEM scratch along its sequential
// time axis, over channel blocks in parallel.  Here a thread keeps h in a
// register, adjacent threads take adjacent channels (every step's loads
// and stores coalesced along C), and the wrapper's `scan_plan` cuts each
// chain's T steps into `chunks` chunks of `len` steps:
//   - 1 chunk where the B x C chains fill the card (Falcon-Mamba's
//     131,072): one thread a chain for all of T (`scan_chains`);
//   - else a chunk-parallel scan in two launches.  Phase 1
//     (`chunk_aggregates`) gives every chunk but the last its product
//     P = prod a_t and its end state H from h = 0, (P, H) to the
//     workspace.  Phase 3 (`chunk_rescan`) first carries the state into
//     its chunk, h_in[k] = P[k-1] h_in[k-1] + H[k-1] over the earlier
//     chunks' (P, H) (phase 2, no launch of its own), then reruns the
//     chunk from h_in with the same FMA step as `scan_chains`, so within
//     a chunk the rounding is the sequential scan's.  At the RG-LRU's
//     4,096 chains x 2,048 steps that is 32 chunks of 64: 131,072 threads
//     instead of 32 blocks on 132 SMs.  It reads a and b twice (20 bytes
//     an element in fp32 against 12); phase 3 takes the chunks in reverse
//     order, so the ones phase 1 read last, still in the 50 MB L2, come
//     first.
// The one-pass alternative (kOnePass, timed by `kernels.ablate`) keeps a
// chunk's a, b in shared memory between its aggregate and its rescan and
// takes h_in by decoupled look-back over the chunks' published states in
// ticket order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kThreads = 128;
constexpr bool kOnePass = false;

// h over its earlier chunks' (P, H): exactly H where h is 0, so a chunk
// whose product overflowed is never multiplied by 0.
__device__ __forceinline__ float carry(float2 ph, float h) {
  return h == 0.f ? ph.y : fmaf(ph.x, h, ph.y);
}

// h from `h` over steps [t0, t1) of one chain at `off` (the element of t0),
// every h_t to hs.
template <typename T>
__device__ __forceinline__ float run(const T* __restrict__ a,
                                     const T* __restrict__ b,
                                     float* __restrict__ hs, size_t off,
                                     int t0, int t1, int channels, float h) {
#pragma unroll 8
  for (int t = t0; t < t1; ++t, off += channels) {
    h = fmaf(to_f(a[off]), h, to_f(b[off]));
    hs[off] = h;
  }
  return h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_chains(const T* __restrict__ a, const T* __restrict__ b,
            float* __restrict__ hs, float* __restrict__ hf, int steps,
            int channels) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= channels) return;
  const size_t base = (size_t)blockIdx.y * steps * channels + c;
  hf[(size_t)blockIdx.y * channels + c] =
      run(a, b, hs, base, 0, steps, channels, 0.f);
}

// Phase 1: (P, H) of chunk blockIdx.y (every chunk but the last) of
// batch row blockIdx.z, to agg (B, chunks, C).
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_aggregates(const T* __restrict__ a, const T* __restrict__ b,
                 float2* __restrict__ agg, int steps, int channels,
                 int chunks, int len) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= channels) return;
  const int k = blockIdx.y, t0 = k * len, t1 = min(t0 + len, steps);
  size_t off = ((size_t)blockIdx.z * steps + t0) * channels + c;
  float p = 1.f, h = 0.f;
#pragma unroll 8
  for (int t = t0; t < t1; ++t, off += channels) {
    const float at = to_f(a[off]);
    p *= at;
    h = fmaf(at, h, to_f(b[off]));
  }
  agg[((size_t)blockIdx.z * chunks + k) * channels + c] = make_float2(p, h);
}

// Phases 2 and 3: carry the state into chunk k (last chunks first), rerun
// it and write its hs, and h_final from the last chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_rescan(const T* __restrict__ a, const T* __restrict__ b,
             const float2* __restrict__ agg, float* __restrict__ hs,
             float* __restrict__ hf, int steps, int channels, int chunks,
             int len) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= channels) return;
  const int k = chunks - 1 - blockIdx.y, t0 = k * len;
  const float2* ag = agg + (size_t)blockIdx.z * chunks * channels + c;
  float h = 0.f;
#pragma unroll 8
  for (int j = 0; j < k; ++j) h = carry(ag[(size_t)j * channels], h);
  const size_t off = ((size_t)blockIdx.z * steps + t0) * channels + c;
  h = run(a, b, hs, off, t0, min(t0 + len, steps), channels, h);
  if (k == chunks - 1) hf[(size_t)blockIdx.z * channels + c] = h;
}

// The one-pass alternative's workspace after agg: each chunk's end state
// (B, chunks, C) fp32, a flag a (chunk, batch row, channel block) tile
// (0 nothing, 1 (P, H) published, 2 end state published), the ticket.
struct OnePass {
  float* state;
  int* flag;
  int* ticket;
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// One tile (128 channels x len steps) a block, tiles taken in ticket order
// chunk-major, so every tile a block waits on belongs to a block that
// started before it.  Dynamic shared memory: a and b of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_onepass(const T* __restrict__ a, const T* __restrict__ b,
              float2* agg, OnePass w, float* __restrict__ hs,
              float* __restrict__ hf, int batch, int steps, int channels,
              int chunks, int len) {
  extern __shared__ unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + (size_t)len * kThreads;
  __shared__ int s_tile, s_from;
  if (threadIdx.x == 0) s_tile = atomicAdd(w.ticket, 1);
  __syncthreads();
  const int cblocks = (channels + kThreads - 1) / kThreads;
  const int tile = s_tile, k = tile / (batch * cblocks);
  const int bi = tile % (batch * cblocks) / cblocks;
  const int cb = tile % cblocks;
  const int c = cb * kThreads + threadIdx.x;
  const bool live = c < channels;
  const int t0 = k * len, n = min(len, steps - t0);
  const size_t cell = ((size_t)bi * chunks + k) * channels + c;
  auto flag_of = [&](int j) { return w.flag + ((size_t)j * batch + bi) *
                                                  cblocks + cb; };

  float p = 1.f, h = 0.f;
  if (live) {
    size_t off = ((size_t)bi * steps + t0) * channels + c;
#pragma unroll 8
    for (int i = 0; i < n; ++i, off += channels) {
      const T at = a[off], bt = b[off];
      sa[i * kThreads + threadIdx.x] = at;
      sb[i * kThreads + threadIdx.x] = bt;
      p *= to_f(at);
      h = fmaf(to_f(at), h, to_f(bt));
    }
    if (k == 0) w.state[cell] = h;
    else agg[cell] = make_float2(p, h);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(flag_of(k), k == 0 ? 2 : 1);

  float hin = 0.f;
  if (k > 0) {
    // warp 0 finds the nearest earlier chunk whose end state is published
    // with every chunk after it at least aggregated
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int base = k - 1;
      for (;;) {
        const int j = base - lane;
        const int f = j >= 0 ? load_acquire(flag_of(j)) : 0;
        const unsigned done = __ballot_sync(0xffffffffu, f == 2);
        const unsigned wait = __ballot_sync(0xffffffffu, f == 0);
        const int first_done = done ? __ffs(done) - 1 : 32;
        const int first_wait = wait ? __ffs(wait) - 1 : 32;
        if (first_done < first_wait) {
          if (lane == 0) s_from = base - first_done;
          break;
        }
        if (first_wait == 32) base -= 32;
        else __nanosleep(64);
      }
    }
    __syncthreads();
    if (live) {
      const int from = s_from;
      const size_t col = (size_t)bi * chunks * channels + c;
      hin = __ldcg(w.state + col + (size_t)from * channels);
      for (int j = from + 1; j < k; ++j)
        hin = carry(__ldcg(agg + col + (size_t)j * channels), hin);
      w.state[cell] = carry(make_float2(p, h), hin);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) store_release(flag_of(k), 2);
  }

  if (!live) return;
  size_t off = ((size_t)bi * steps + t0) * channels + c;
  h = hin;
#pragma unroll 8
  for (int i = 0; i < n; ++i, off += channels) {
    h = fmaf(to_f(sa[i * kThreads + threadIdx.x]), h,
             to_f(sb[i * kThreads + threadIdx.x]));
    hs[off] = h;
  }
  if (k == chunks - 1) hf[(size_t)bi * channels + c] = h;
}

size_t agg_bytes(int batch, int channels, int chunks) {
  return (size_t)batch * chunks * channels * sizeof(float2);
}

size_t workspace_bytes(int batch, int channels, int chunks) {
  if (chunks <= 1) return 0;
  if (!kOnePass) return agg_bytes(batch, channels, chunks);
  const size_t cells = (size_t)batch * chunks * channels;
  const size_t tiles = (size_t)batch * chunks *
                       ((channels + kThreads - 1) / kThreads);
  return agg_bytes(batch, channels, chunks) + cells * 4 + (tiles + 1) * 4;
}

template <typename T>
int launch(const void* ap, const void* bp, void* hsp, void* hfp, void* work,
           int batch, int steps, int channels, int chunks, int len,
           void* stream) {
  const T* a = static_cast<const T*>(ap);
  const T* b = static_cast<const T*>(bp);
  float* hs = static_cast<float*>(hsp);
  float* hf = static_cast<float*>(hfp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cblocks = (channels + kThreads - 1) / kThreads;
  if (chunks < 1 || (long long)(chunks - 1) * len >= steps ||
      (long long)chunks * len < steps)
    return (int)cudaErrorInvalidValue;       // chunks must cover T exactly
  if (chunks == 1) {
    scan_chains<T><<<dim3(cblocks, batch), kThreads, 0, st>>>(
        a, b, hs, hf, steps, channels);
    return static_cast<int>(cudaGetLastError());
  }
  float2* agg = static_cast<float2*>(work);
  if constexpr (kOnePass) {
    unsigned char* rest = static_cast<unsigned char*>(work) +
                          agg_bytes(batch, channels, chunks);
    const size_t cells = (size_t)batch * chunks * channels;
    const size_t tiles = (size_t)batch * chunks * cblocks;
    OnePass w{reinterpret_cast<float*>(rest),
              reinterpret_cast<int*>(rest + cells * 4),
              reinterpret_cast<int*>(rest + cells * 4) + tiles};
    cudaError_t err = cudaMemsetAsync(w.flag, 0, (tiles + 1) * 4, st);
    if (err != cudaSuccess) return (int)err;
    const size_t shm = 2 * (size_t)len * kThreads * sizeof(T);
    err = cudaFuncSetAttribute(chunk_onepass<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
    if (err != cudaSuccess) return (int)err;
    chunk_onepass<T><<<(unsigned)tiles, kThreads, shm, st>>>(
        a, b, agg, w, hs, hf, batch, steps, channels, chunks, len);
  } else {
    const dim3 aggs(cblocks, chunks - 1, batch), all(cblocks, chunks, batch);
    chunk_aggregates<T><<<aggs, kThreads, 0, st>>>(a, b, agg, steps,
                                                   channels, chunks, len);
    chunk_rescan<T><<<all, kThreads, 0, st>>>(a, b, agg, hs, hf, steps,
                                              channels, chunks, len);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of device workspace a call with `chunks` chunks needs (0 for one).
extern "C" size_t ssm_scan_workspace(int batch, int channels, int chunks) {
  return workspace_bytes(batch, channels, chunks);
}

// a, b: (batch, steps, channels) row-major of the named input type; hs:
// (batch, steps, channels) fp32; hf: (batch, channels) fp32; work:
// ssm_scan_workspace bytes; chunks x len covers steps, the last chunk
// short.  Returns the CUDA error code of the launch (0 on success).
extern "C" int ssm_scan_bf16_f32(const void* a, const void* b, void* hs,
                                 void* hf, void* work, int batch, int steps,
                                 int channels, int chunks, int len,
                                 void* stream) {
  return launch<__nv_bfloat16>(a, b, hs, hf, work, batch, steps, channels,
                               chunks, len, stream);
}

extern "C" int ssm_scan_f32_f32(const void* a, const void* b, void* hs,
                                void* hf, void* work, int batch, int steps,
                                int channels, int chunks, int len,
                                void* stream) {
  return launch<float>(a, b, hs, hf, work, batch, steps, channels, chunks,
                       len, stream);
}
