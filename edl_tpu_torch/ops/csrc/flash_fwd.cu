// Flash-attention forward for Hopper (sm_90a): O = softmax(mask(q*scale . k^T)) . v
//
// Replaces the two Pallas TPU kernels of edl_tpu/ops/flash_attention.py:
//   _fwd_kernel_resident (the whole K/V row resident in VMEM, a fori_loop
//   over kv blocks that stops at the causal diagonal) and _fwd_kernel (the
//   kv axis as a sequential grid dimension with acc/m/l carried in VMEM
//   scratch, ragged kv masked). One kernel covers both: thread blocks run in
//   parallel and in no order on the card, so the sequential kv grid axis and
//   its scratch carry become a loop inside the block, with acc/m/l in
//   registers.
//
// Layout: q, o are [bh, s, d]; k, v are [bh, sk, d]; contiguous, 16-byte
// aligned; bf16 or f32 (o has q's type). d is a multiple of 8, at most 256.
// lse, when not NULL, is f32 [bh, s]: each row's m + log(max(l, 1e-30)) over
// the scaled, masked scores, for the backward (csrc/flash_bwd.cu). Rows at
// or past s are not written.
//
// Semantics kept from the TPU kernel: inputs are upcast to f32 before every
// product, sm_scale multiplies q after the upcast, scores and the online
// softmax are f32, masked scores are -1e30 and their probabilities 0, the
// output is acc / max(l, 1e-30). The causal diagonal is anchored at
// position 0 (q row i sees keys 0..i) even when sk != s, keys at or beyond
// sk are masked, and q rows at or beyond s are computed on zeros but never
// stored.
//
// What bounds it. At the serving shapes (b*h = 48, s = sk = 1024, d = 64,
// bf16, causal) the function moves 25.2 MB (q, k, v read once, o written
// once) and does 6.45 GFLOP in its two products: 7.5 us at the card's
// 3.35 TB/s, 6.5 us at its 989 TFLOP/s bf16 tensor-core rate. So the bound
// is memory, and a kernel near it would keep K/V tiles flowing through
// shared memory and run the products on wgmma. This first design does not
// try: it keeps the f32 arithmetic of the reference on the CUDA cores
// (67 TFLOP/s f32), so the products, not the bytes, set its time. What it
// does about memory: each 64-row q tile is read once, each 64-row K/V tile
// is staged once per q tile into shared memory with 16-byte loads and
// reused by all 256 threads, the score tile never leaves shared memory, and
// the causal loop stops at the tile that holds the diagonal, so nothing to
// its right is loaded or computed.
//
// Thread layout: 256 threads as 16 x 16 (ty, tx). Thread (ty, tx) owns q
// rows ty + 16*i (i < 4) and, in the score tile, key columns tx + 16*j
// (j < 4); in the output, columns tx + 16*j (j < DMAX/16). The 16 threads
// of one row share a half-warp, so row max and row sum reduce by shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // q rows per block
constexpr int BN = 64;    // kv rows per tile
constexpr int NT = 256;   // threads per block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    dst[2 * e] = f.x;
    dst[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared memory, in floats: q and k tiles with an odd row stride (d + 1)
// so that 16 threads reading one column of 16 rows hit 16 banks; the v tile
// is read along rows and needs no pad; the probability tile likewise padded.
__host__ __device__ __forceinline__ size_t smem_floats(int d) {
  return (size_t)(BM + BN) * (d + 1) + (size_t)BN * d + (size_t)BM * (BN + 1);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int s, int sk, int d,
                 float sm_scale, int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;               // [BM][ld], q * sm_scale in f32
  float* ks = qs + BM * ld;       // [BN][ld]
  float* vs = ks + BN * ld;       // [BN][d]
  float* ps = vs + BN * d;        // [BM][BN + 1]

  const int q0 = blockIdx.x * BM;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * s * d;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;
  T* ob = o + bh * s * d;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  constexpr int EV = 16 / sizeof(T);   // elements per 16-byte load
  const int chunks = d / EV;           // 16-byte chunks per row

  for (int idx = tid; idx < BM * chunks; idx += NT) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * EV;
    float tmp[EV];
    if (q0 + r < s) {
      load16(qb + (size_t)(q0 + r) * d + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < EV; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EV; ++e) qs[r * ld + c + e] = tmp[e] * sm_scale;
  }

  constexpr int OJ = DMAX / 16;        // output columns per thread
  float acc[4][OJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (sk + BN - 1) / BN;
  if (causal) {
    // the last kv tile that holds a key at or left of this tile's last row
    const int last = (q0 + BM - 1) / BN + 1;
    n_tiles = min(n_tiles, last);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();   // the previous tile's reads of ks/vs/ps are done
    for (int idx = tid; idx < BN * chunks; idx += NT) {
      const int r = idx / chunks;
      const int c = (idx - r * chunks) * EV;
      float kt[EV], vt[EV];
      if (k0 + r < sk) {
        load16(kb + (size_t)(k0 + r) * d + c, kt);
        load16(vb + (size_t)(k0 + r) * d + c, vt);
      } else {
#pragma unroll
        for (int e = 0; e < EV; ++e) kt[e] = vt[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EV; ++e) {
        ks[r * ld + c + e] = kt[e];
        vs[r * d + c + e] = vt[e];
      }
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ld + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < sk && (!causal || qp >= kp);
        if (!ok[j]) sc[i][j] = kNegInf;
        row_max = fmaxf(row_max, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * (BN + 1) + tx + 16 * j] = p;
        row_sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int n = 0; n < BN; ++n) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (BN + 1) + n];
#pragma unroll
      for (int j = 0; j < OJ; ++j) {
        const int c = tx + 16 * j;
        if (c < d) {
          const float vv = vs[n * d + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // the half-warp's 16 lanes hold the row's m and l: one stores them
    if (lse != nullptr && tx == 0) lse[bh * s + qp] = m[i] + logf(denom);
#pragma unroll
    for (int j = 0; j < OJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store1(ob + (size_t)qp * d + c, acc[i][j] / denom);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int s, int sk, int d, float sm_scale,
                   int causal, cudaStream_t stream) {
  const size_t bytes = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + BM - 1) / BM, bh);
  flash_fwd_kernel<T, DMAX><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, s, sk, d, sm_scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int s, int sk, int d,
                       float sm_scale, int causal, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, bh, s, sk, d, sm_scale, causal,
                         stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, lse, bh, s, sk, d, sm_scale, causal,
                          stream);
  return launch<T, 256>(q, k, v, o, lse, bh, s, sk, d, sm_scale, causal,
                        stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The caller has checked shapes, types,
// contiguity, alignment, d % 8 == 0 and d <= 256, and allocated lse (f32
// [bh, s]) or passes NULL for none. Returns cudaGetLastError() after the
// launch (0 = success); allocates nothing and does not synchronise.
extern "C" int edl_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int bh, int s, int sk,
                             int d, float sm_scale, int causal, int dtype,
                             void* stream) {
  if (bh <= 0 || s <= 0 || sk <= 0 || d <= 0 || d > 256 || d % 8 != 0 ||
      bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, lse, bh, s, sk, d, sm_scale,
                                  causal, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, s, sk, d,
                                          sm_scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* edl_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
