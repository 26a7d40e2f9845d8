// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of
// O = softmax(mask(q*scale . k^T)) . v, by recompute, from the lse that the
// forward kernel saved, in three kernels.
//
// Replaces the JAX package's backward, edl_tpu/ops/flash_attention.py
// _flash_bwd (a custom_vjp over two lax.scan passes; XLA, not Pallas). Its
// pass 1 recomputes each q row's softmax statistics (m, l) over the kv
// blocks and takes delta = rowsum(g * out); its pass 2 walks the kv blocks
// once more, carrying dq and emitting each block's dk and dv. Here the
// statistics are not recomputed: every forward kernel (flash_fwd_sm90.cu,
// flash_fwd_tf32x3.cu, flash_fwd.cu) writes lse = m + log(max(l, 1e-30))
// beside O when the autograd function asks for it, the same function of q
// and k as pass 1's (m, l), so what is left of pass 1 is delta. On the card
// thread blocks run in parallel and in no order, so pass 2's carry becomes
// a loop inside a block, and the two outputs that pass 2 reduces over
// different axes get a kernel each, in FlashAttention-2's order (no
// atomics):
//
//   edl_flash_bwd_delta  TPR adjacent lanes per q row: delta = rowsum(g*o);
//   edl_flash_bwd_dq     one block per (bh, q tile), looping over kv tiles:
//                        dq = sm_scale * sum_j ds_ij k_j;
//   edl_flash_bwd_dkdv   one block per (bh, kv tile), looping over q tiles:
//                        dv = p^T g, dk = ds^T (q * sm_scale);
//
// with p = exp(s - lse) (0 where masked), dp = g . v^T, ds = p * (dp -
// delta). For bf16 at head_dim 64 and 128, flash_bwd_sm90.cu's tensor-core
// dq and dk/dv run after bwd_delta in place of this file's
// (ops/flash_attention.py:bwd_kernel_for decides).
//
// Layout: q, o, g, dq are [bh, s, d]; k, v, dk, dv are [bh, sk, d]; lse and
// delta are f32 [bh, s]. Contiguous, 16-byte aligned; bf16 or f32 (the
// gradients have the inputs' type). d is a multiple of 8, at most 256.
//
// Semantics kept from the reference: every product is f32 on f32 upcasts,
// sm_scale multiplies q after the upcast, masked scores are -1e30 and their
// probabilities 0. The causal diagonal is anchored at position 0 (q row i
// sees keys 0..i) when sk != s, keys at or past sk are masked and read as
// zeros (never past sk), and kv rows that no query reaches (causal with
// s < sk) get zero dk and dv, written.
//
// What bounds it. The backward's five products (s, dp, dv, dq, dk) cost
// 10 * d flops per (query, key) pair; at GPT-2 small's training shape (b*h
// = 96, s = sk = 1024, d = 64, bf16, causal) that is 32.2 GFLOP, 33 us at
// the card's 989 TFLOP/s bf16 rate, against 101 MB moved (q, k, v, o, g
// read once, dq, dk, dv written once), 30 us at 3.35 TB/s: operations
// bound, narrowly.
// - bwd_delta does no product: it reads g and o once and writes delta,
//   25.6 MB at that shape, 7.63 us at 3.35 TB/s, so bytes bound it, and it
//   is designed for bandwidth. A row's TPR lanes (the power of two at or
//   above the row's 16-byte chunks, at most 32) each read 16-byte vectors
//   of g and o and sum their products in f32; shuffles within the row's
//   lanes finish the sum and the row's first lane stores it. Consecutive
//   rows lie in consecutive lanes, so a warp reads one contiguous run of
//   each tensor. No shared memory, no tensor cores.
// - dq and dk/dv keep the reference's f32 arithmetic on the CUDA cores
//   (67 TFLOP/s), and the recompute adds two products (s and dp are taken
//   in both: seven in all), so they run far from that bound; the tensor
//   cores are flash_bwd_sm90.cu's. What they do about the CUDA cores'
//   rate: every product is a 256-thread register tile of 4 adjacent
//   columns by TM rows per thread, both operands read from shared memory
//   as float4 rows laid out k-major, so a thread does 4 * TM fused
//   multiply-adds per TM/4 + 1 shared loads; the operands are staged once
//   per tile in the layout each product reads (transposed where they are
//   the contracted side), the score tile is made in the orientation whose
//   rows are the next product's contracted axis so that p and ds are
//   stored as float4 rows, and the causal loops stop at the diagonal tile.
//
// Tiles: B = 64 rows of q and of kv at d <= 64, B = 32 above (shared memory:
// the dk/dv kernel holds k and v transposed, q and g both ways, p and ds:
// 130 KB at d 64, 201 KB at d 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block
constexpr float kNegInf = -1e30f;

template <int DMAX>
struct Tile {
  static constexpr int B = DMAX <= 64 ? 64 : 32;
  static constexpr int LDR = DMAX + 4;   // row stride of a row-major tile
};

// An M x N product over NT threads: TX threads along N with 4 adjacent
// columns each, TY along M with TM adjacent rows each.
template <int M, int N>
struct Geo {
  static constexpr int TX = N / 4;
  static constexpr int TY = NT / TX;
  static constexpr int TM = M / TY;
  static_assert(TX * TY == NT && TM * TY == M && TM >= 1, "tile geometry");
};

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

// sum over the W adjacent lanes that share a row (W a power of 2)
template <int W>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// c[i][j] += sum_kk at[kk][m0 + i] * bt[kk][n0 + j] over kk < kn, i < TM,
// j < 4: both operands k-major in shared memory (rows lda and ldb floats
// apart, multiples of 4, as are m0 and n0).
template <int TM>
__device__ __forceinline__ void mm(const float* __restrict__ at, int lda,
                                   const float* __restrict__ bt, int ldb,
                                   int kn, int m0, int n0,
                                   float (&c)[TM][4]) {
#pragma unroll 4
  for (int kk = 0; kk < kn; ++kk) {
    const float* ar = at + kk * lda + m0;
    float a[TM];
    if constexpr (TM % 4 == 0) {
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(ar + i);
        a[i] = x.x; a[i + 1] = x.y; a[i + 2] = x.z; a[i + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ar[i];
    }
    const float4 b = *reinterpret_cast<const float4*>(bt + kk * ldb + n0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      c[i][0] = fmaf(a[i], b.x, c[i][0]);
      c[i][1] = fmaf(a[i], b.y, c[i][1]);
      c[i][2] = fmaf(a[i], b.z, c[i][2]);
      c[i][3] = fmaf(a[i], b.w, c[i][3]);
    }
  }
}

template <int TM>
__device__ __forceinline__ void zero(float (&c)[TM][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
}

// Rows [r0, r0 + B) of a [n_rows][d] matrix, times scale, in f32: into tr
// as [c][r] (row stride B; the contracted side of a product) when TR, into
// rm as [r][c] (row stride ldr) when RM. Rows at or past n_rows are zeros
// and are not read. Consecutive threads take consecutive rows, so the
// transposed stores hit consecutive banks and the row stores (ldr = d_max +
// 4) eight distinct 16-byte bank groups.
template <int B, bool TR, bool RM, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int r0,
                                          int n_rows, int d, float scale,
                                          float* tr, float* rm, int ldr) {
  constexpr int EV = 16 / sizeof(T);   // elements per 16-byte load
  const int chunks = d / EV;
  for (int idx = threadIdx.x; idx < B * chunks; idx += NT) {
    const int r = idx % B;
    const int c = (idx / B) * EV;
    float x[EV];
    if (r0 + r < n_rows) {
      load16(src + (size_t)(r0 + r) * d + c, x);
#pragma unroll
      for (int e = 0; e < EV; ++e) x[e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < EV; ++e) x[e] = 0.f;
    }
    if constexpr (TR) {
#pragma unroll
      for (int e = 0; e < EV; ++e) tr[(c + e) * B + r] = x[e];
    }
    if constexpr (RM) {
#pragma unroll
      for (int e = 0; e < EV; e += 4)
        *reinterpret_cast<float4*>(rm + r * ldr + c + e) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  }
}

// delta = rowsum(g * o) of NT / TPR q rows of one (b, h): TPR adjacent lanes
// per row, lane ``part`` summing the row's 16-byte chunks part, part + TPR,
// ...
template <typename T, int TPR>
__global__ void __launch_bounds__(NT)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                 float* __restrict__ delta, int s, int d) {
  constexpr int EV = 16 / sizeof(T);   // elements per 16-byte load
  const int chunks = d / EV;           // a row's 16-byte vectors
  const int row = blockIdx.x * (NT / TPR) + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const size_t bh = blockIdx.y;
  float sum = 0.f;
  if (row < s) {
    const T* gr = g + (bh * s + row) * d;
    const T* orow = o + (bh * s + row) * d;
    for (int c = part; c < chunks; c += TPR) {
      float gv[EV], ov[EV];
      load16(gr + c * EV, gv);
      load16(orow + c * EV, ov);
#pragma unroll
      for (int e = 0; e < EV; ++e) sum = fmaf(gv[e], ov[e], sum);
    }
  }
  sum = group_sum<TPR>(sum);   // every lane takes part: rows past s add 0
  if (part == 0 && row < s) delta[bh * s + row] = sum;
}

// dq of q rows [q0, q0 + B) of one (b, h), over the kv tiles they see.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int s, int sk, int d, float sm_scale,
              int causal) {
  constexpr int B = Tile<DMAX>::B;
  constexpr int LDR = Tile<DMAX>::LDR;
  using GS = Geo<B, B>;      // the score tile s^T: rows keys, columns q
  using GO = Geo<B, DMAX>;   // dq: rows q, columns d
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;             // [DMAX][B] q * sm_scale, transposed
  float* gt = qt + DMAX * B;    // [DMAX][B] g, transposed
  float* kt = gt + DMAX * B;    // [DMAX][B] k, transposed
  float* vt = kt + DMAX * B;    // [DMAX][B] v, transposed
  float* kr = vt + DMAX * B;    // [B][LDR]  k, rows
  float* dst = kr + B * LDR;    // [B][B]    ds^T

  const int q0 = blockIdx.x * B;
  const size_t bh = blockIdx.y;
  q += bh * s * d;
  g += bh * s * d;
  dq += bh * s * d;
  k += bh * sk * d;
  v += bh * sk * d;
  lse += bh * s;
  delta += bh * s;
  const int tid = threadIdx.x;
  const int sx = tid % GS::TX, sy = tid / GS::TX;
  const int sm0 = sy * GS::TM, sn0 = sx * 4;
  const int ox = tid % GO::TX, oy = tid / GO::TX;
  const int om0 = oy * GO::TM, on0 = ox * 4;

  float lse_c[4], delta_c[4];   // of this thread's 4 q columns
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int qp = q0 + sn0 + j;
    lse_c[j] = qp < s ? lse[qp] : 0.f;
    delta_c[j] = qp < s ? delta[qp] : 0.f;
  }
  load_rows<B, true, false>(q, q0, s, d, sm_scale, qt, nullptr, 0);
  load_rows<B, true, false>(g, q0, s, d, 1.f, gt, nullptr, 0);

  float acc[GO::TM][4];
  zero(acc);
  int n_tiles = (sk + B - 1) / B;
  if (causal) n_tiles = min(n_tiles, (q0 + B - 1) / B + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * B;
    __syncthreads();   // the last tile's reads of kt, vt, kr, dst are done
    load_rows<B, true, true>(k, k0, sk, d, 1.f, kt, kr, LDR);
    load_rows<B, true, false>(v, k0, sk, d, 1.f, vt, nullptr, 0);
    __syncthreads();
    float st[GS::TM][4], dpt[GS::TM][4];
    zero(st);
    zero(dpt);
    mm<GS::TM>(kt, B, qt, B, d, sm0, sn0, st);    // s^T[j][i] = k_j . q_i
    mm<GS::TM>(vt, B, gt, B, d, sm0, sn0, dpt);   // dp^T[j][i] = v_j . g_i
#pragma unroll
    for (int i = 0; i < GS::TM; ++i) {
      const int kp = k0 + sm0 + i;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qp = q0 + sn0 + j;
        const bool ok = kp < sk && qp < s && (!causal || qp >= kp);
        const float p = ok ? expf(st[i][j] - lse_c[j]) : 0.f;
        ds[j] = p * (dpt[i][j] - delta_c[j]);
      }
      *reinterpret_cast<float4*>(dst + (sm0 + i) * B + sn0) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    mm<GO::TM>(dst, B, kr, LDR, B, om0, on0, acc);   // dq_i += ds_ij k_j
  }
#pragma unroll
  for (int i = 0; i < GO::TM; ++i) {
    const int qp = q0 + om0 + i;
    if (qp >= s) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = on0 + j;
      if (c < d) store1(dq + (size_t)qp * d + c, sm_scale * acc[i][j]);
    }
  }
}

// dk and dv of kv rows [k0, k0 + B) of one (b, h), over the q tiles that
// see them.
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ g,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int s, int sk, int d, float sm_scale,
                int causal) {
  constexpr int B = Tile<DMAX>::B;
  constexpr int LDR = Tile<DMAX>::LDR;
  using GS = Geo<B, B>;      // the score tile s: rows q, columns keys
  using GO = Geo<B, DMAX>;   // dk, dv: rows keys, columns d
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* kt = smem;             // [DMAX][B] k, transposed
  float* vt = kt + DMAX * B;    // [DMAX][B] v, transposed
  float* qt = vt + DMAX * B;    // [DMAX][B] q * sm_scale, transposed
  float* gt = qt + DMAX * B;    // [DMAX][B] g, transposed
  float* qr = gt + DMAX * B;    // [B][LDR]  q * sm_scale, rows
  float* gr = qr + B * LDR;     // [B][LDR]  g, rows
  float* ps = gr + B * LDR;     // [B][B]    p
  float* dss = ps + B * B;      // [B][B]    ds
  float* lse_s = dss + B * B;   // [B]
  float* delta_s = lse_s + B;   // [B]

  const int k0 = blockIdx.x * B;
  const size_t bh = blockIdx.y;
  q += bh * s * d;
  g += bh * s * d;
  k += bh * sk * d;
  v += bh * sk * d;
  dk += bh * sk * d;
  dv += bh * sk * d;
  lse += bh * s;
  delta += bh * s;
  const int tid = threadIdx.x;
  const int sx = tid % GS::TX, sy = tid / GS::TX;
  const int sm0 = sy * GS::TM, sn0 = sx * 4;
  const int ox = tid % GO::TX, oy = tid / GO::TX;
  const int om0 = oy * GO::TM, on0 = ox * 4;

  load_rows<B, true, false>(k, k0, sk, d, 1.f, kt, nullptr, 0);
  load_rows<B, true, false>(v, k0, sk, d, 1.f, vt, nullptr, 0);
  float dk_acc[GO::TM][4], dv_acc[GO::TM][4];
  zero(dk_acc);
  zero(dv_acc);
  const int n_q = (s + B - 1) / B;
  // kv rows that no query reaches (causal, k0 >= s) run no tile and still
  // write their zero dk and dv below
  const int first = causal ? k0 / B : 0;
  for (int t = first; t < n_q; ++t) {
    const int i0 = t * B;
    __syncthreads();   // the last tile's reads of q, g, p, ds are done
    load_rows<B, true, true>(q, i0, s, d, sm_scale, qt, qr, LDR);
    load_rows<B, true, true>(g, i0, s, d, 1.f, gt, gr, LDR);
    for (int r = tid; r < B; r += NT) {
      lse_s[r] = i0 + r < s ? lse[i0 + r] : 0.f;
      delta_s[r] = i0 + r < s ? delta[i0 + r] : 0.f;
    }
    __syncthreads();
    float sc[GS::TM][4], dp[GS::TM][4];
    zero(sc);
    zero(dp);
    mm<GS::TM>(qt, B, kt, B, d, sm0, sn0, sc);   // s[i][j] = q_i . k_j
    mm<GS::TM>(gt, B, vt, B, d, sm0, sn0, dp);   // dp[i][j] = g_i . v_j
#pragma unroll
    for (int i = 0; i < GS::TM; ++i) {
      const int qp = i0 + sm0 + i;
      const float row_lse = lse_s[sm0 + i], row_delta = delta_s[sm0 + i];
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + sn0 + j;
        const bool ok = qp < s && kp < sk && (!causal || qp >= kp);
        p[j] = ok ? expf(sc[i][j] - row_lse) : 0.f;
        ds[j] = p[j] * (dp[i][j] - row_delta);
      }
      *reinterpret_cast<float4*>(ps + (sm0 + i) * B + sn0) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dss + (sm0 + i) * B + sn0) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    mm<GO::TM>(ps, B, gr, LDR, B, om0, on0, dv_acc);    // dv_j += p_ij g_i
    mm<GO::TM>(dss, B, qr, LDR, B, om0, on0, dk_acc);   // dk_j += ds_ij q_i
  }
#pragma unroll
  for (int i = 0; i < GO::TM; ++i) {
    const int kp = k0 + om0 + i;
    if (kp >= sk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = on0 + j;
      if (c < d) {
        store1(dk + (size_t)kp * d + c, dk_acc[i][j]);
        store1(dv + (size_t)kp * d + c, dv_acc[i][j]);
      }
    }
  }
}

template <int DMAX>
constexpr size_t dq_smem() {
  constexpr int B = Tile<DMAX>::B;
  return sizeof(float) *
         (4 * DMAX * B + B * Tile<DMAX>::LDR + B * B);
}

template <int DMAX>
constexpr size_t dkdv_smem() {
  constexpr int B = Tile<DMAX>::B;
  return sizeof(float) *
         (4 * DMAX * B + 2 * B * Tile<DMAX>::LDR + 2 * B * B + 2 * B);
}

struct Args {
  const void *q, *k, *v, *o, *g;
  float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, s, sk, d;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

enum Which { kDq, kDkdv };

template <typename T, int DMAX>
cudaError_t launch(Which which, const Args& a) {
  constexpr int B = Tile<DMAX>::B;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  cudaError_t err;
  if (which == kDq) {
    const size_t bytes = dq_smem<DMAX>();
    if ((err = prepare(bwd_dq_kernel<T, DMAX>, bytes)) != cudaSuccess)
      return err;
    const dim3 grid((a.s + B - 1) / B, a.bh);
    bwd_dq_kernel<T, DMAX><<<grid, NT, bytes, a.stream>>>(
        q, k, v, g, a.lse, a.delta, static_cast<T*>(a.dq), a.s, a.sk, a.d,
        a.sm_scale, a.causal);
  } else {
    const size_t bytes = dkdv_smem<DMAX>();
    if ((err = prepare(bwd_dkdv_kernel<T, DMAX>, bytes)) != cudaSuccess)
      return err;
    const dim3 grid((a.sk + B - 1) / B, a.bh);
    bwd_dkdv_kernel<T, DMAX><<<grid, NT, bytes, a.stream>>>(
        q, k, v, g, a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.s, a.sk, a.d, a.sm_scale, a.causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Which which, const Args& a) {
  if (a.d <= 64) return launch<T, 64>(which, a);
  if (a.d <= 128) return launch<T, 128>(which, a);
  return launch<T, 256>(which, a);
}

bool valid(const Args& a) {
  return a.bh > 0 && a.s > 0 && a.sk > 0 && a.d > 0 && a.d <= 256 &&
         a.d % 8 == 0 && a.bh <= 65535;
}

int run(Which which, const Args& a, int dtype) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_d<float>(which, a);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(which, a);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int TPR>
cudaError_t launch_delta(const Args& a) {
  const dim3 grid((a.s + NT / TPR - 1) / (NT / TPR), a.bh);
  bwd_delta_kernel<T, TPR><<<grid, NT, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.g), a.delta, a.s,
      a.d);
  return cudaGetLastError();
}

// TPR: the power of two at or above the row's 16-byte chunks, at most 32
template <typename T>
cudaError_t dispatch_delta(const Args& a) {
  const int chunks = a.d / (16 / (int)sizeof(T));
  if (chunks <= 1) return launch_delta<T, 1>(a);
  if (chunks <= 2) return launch_delta<T, 2>(a);
  if (chunks <= 4) return launch_delta<T, 4>(a);
  if (chunks <= 8) return launch_delta<T, 8>(a);
  if (chunks <= 16) return launch_delta<T, 16>(a);
  return launch_delta<T, 32>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The caller has checked shapes, types,
// contiguity, alignment, d % 8 == 0 and d <= 256, and allocated delta (f32
// [bh, s]) and the gradients; lse (f32 [bh, s]) is the forward's. Each
// returns cudaGetLastError() after its launch (0 = success); none allocates
// or synchronises.
extern "C" int edl_flash_bwd_delta(const void* o, const void* g, float* delta,
                                   int bh, int s, int d, int dtype,
                                   void* stream) {
  Args a{nullptr, nullptr, nullptr, o, g, nullptr, delta, nullptr, nullptr,
         nullptr, bh, s, 1, d, 0.f, 0, static_cast<cudaStream_t>(stream)};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_delta<float>(a);
  if (dtype == 1) return (int)dispatch_delta<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

extern "C" int edl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* g, const float* lse,
                                const float* delta, void* dq, int bh, int s,
                                int sk, int d, float sm_scale, int causal,
                                int dtype, void* stream) {
  Args a{q, k, v, nullptr, g, const_cast<float*>(lse),
         const_cast<float*>(delta), dq, nullptr, nullptr, bh, s, sk, d,
         sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return run(kDq, a, dtype);
}

extern "C" int edl_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* g, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  int bh, int s, int sk, int d, float sm_scale,
                                  int causal, int dtype, void* stream) {
  Args a{q, k, v, nullptr, g, const_cast<float*>(lse),
         const_cast<float*>(delta), nullptr, dk, dv, bh, s, sk, d, sm_scale,
         causal, static_cast<cudaStream_t>(stream)};
  return run(kDkdv, a, dtype);
}

extern "C" const char* edl_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
