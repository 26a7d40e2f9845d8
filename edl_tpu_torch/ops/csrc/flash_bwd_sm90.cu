// Flash-attention backward for Hopper (sm_90a) on bf16 at head_dim 64 or
// 128: dq, dk and dv of O = softmax(mask(q . k^T * scale)) . v, by
// recompute, on the tensor cores.
//
// Replaces, for the bf16 training path, two of the three kernels of
// csrc/flash_bwd.cu (f32 FFMA), themselves the port of the JAX package's
// backward, edl_tpu/ops/flash_attention.py _flash_bwd (:254, a custom_vjp
// over two lax.scan passes; XLA, not Pallas). It computes what _flash_bwd's
// pass 2 computes, from the lse that the forward kernel wrote
// (flash_fwd_sm90.cu; the softmax statistics that _flash_bwd's pass 1
// recomputes) and delta = rowsum(g * out) from flash_bwd.cu's bwd_delta,
// with FlashAttention-2's split of pass 2 into two kernels, no atomics:
//
//   edl_flash_bwd_dq_sm90    one warpgroup per (bh, 64-row q tile), over kv
//                            tiles: dq = sm_scale * sum_j ds_ij k_j;
//   edl_flash_bwd_dkdv_sm90  one warpgroup per (bh, 64-key kv tile), over
//                            q tiles: dv = p^T g, dk = sm_scale * ds^T q;
//
// with p = exp(s * sm_scale - lse) (0 where masked), dp = g . v^T and
// ds = p * (dp - delta). ops/flash_attention.py:bwd_kernel_for sends bf16
// at head_dim 64 (the training path of GPT-2s and BERT-base) and 128 here,
// and everything else to flash_bwd.cu.
//
// Layout: q, g, dq are [bh, s, d]; k, v, dk, dv are [bh, sk, d], contiguous
// bf16, 16-byte aligned; lse and delta are f32 [bh, s]; d is 64 or 128.
//
// Semantics kept from the reference: the causal diagonal is anchored at
// position 0 (q row i sees keys 0..i) when s != sk; keys at or beyond sk
// are masked and their probabilities are exactly 0; kv rows that no query
// reaches (causal, s < sk) get dk = dv = 0, written; sm_scale multiplies
// the f32 scores after the product and dq and dk at the end (the
// reference's q * sm_scale carries it into both).
//
// Design. Both kernels are the forward's (flash_fwd_sm90.cu) structure and
// share its helpers (hopper.cuh, namespace wgmma_bf16):
// - TMA copies 64-row boxes of 64 bf16 columns with the 128-byte swizzle
//   through 3-D [bh, rows, d] tensor maps: what lies at or beyond s or sk
//   reads as zeros; d = 128 takes two boxes per tile. dk/dv loads its K and V tiles once and streams (q, g)
//   tile pairs through a ring of STAGES slots, one mbarrier each; dq loads
//   q and g once and streams (K, V). A tile in shared memory serves both as
//   a K-major operand (the contraction over d) and, through the
//   descriptor's transpose bit, as an MN-major one (the contraction over
//   its rows), so nothing is transposed or copied.
// - Five products per (q tile, kv tile) pair, all wgmma m64nNk16 with f32
//   accumulators (N = 64, and N = d for dq, dk and dv); dk/dv takes S^T = K Q^T and dP^T = V dO^T from shared
//   memory, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as the A
//   operand in registers (the accumulator fragment is the A fragment);
//   dq takes S = Q K^T and dP = dO V^T, then dQ += dS K. s and dp are
//   taken in both kernels: seven products where the function needs five.
// - bf16 x bf16 products are exact in f32, so s and dp keep the
//   reference's f32 upcast up to the order of the sums. P and dS are f32
//   and enter a product as a bf16 operand: each is split into
//   hi = bf16(x) and lo = bf16(x - hi), two wgmmas into one accumulator,
//   as the forward splits P. Why: rounding them once passes
//   chip_smoke.BWD_TOL only narrowly (tests/test_torch_flash_numerics.py,
//   run as a script, prints the margins), and the margin shrinks as the
//   tensors grow; with the split the emulated excess is under 1e-3 of the
//   atol.
// - In dk/dv, query rows at or beyond s read zero q and g, but their lse
//   and delta lie beyond the head's row (or the tensor): they are never
//   read; their lse is +inf, so p = exp(-inf) = 0 exactly, and delta 0.
// - Causal: dq's tiles launch from the last q tile (the longest kv loop)
//   and stop at the kv tile that holds their diagonal; dk/dv's q loop
//   starts at the q tile that holds row k0. Only tiles that cross the
//   diagonal or sk build the mask.
//
// What bounds it. At GPT-2 small's training shape (bh = 96, s = sk = 1024,
// d = 64, causal) dq's three products cost 19.3 GFLOP (19.56 us at the
// card's 989 TFLOP/s bf16, operations-bound) and dk/dv's four 25.8 GFLOP
// (26.08 us). With the hi/lo split, the products that take P or dS run
// twice. What holds this design back: one warpgroup issues the copies,
// waits, and runs the products and the exp/mask pass in turn, so the
// tensor cores idle during the exp pass; a __syncthreads ends every tile
// before its slot is refilled; each output leaves from registers with
// 4-byte stores. Producer and consumer warpgroups (warp specialisation)
// and two consumer warpgroups per block are the next steps.
//
// Registers (ptxas -v, sm_90a, nvcc 12.9), none spilled: dq 128 at d = 64
// and 168 at d = 128; dk/dv, which holds four 64 x d accumulators (S^T,
// dP^T, dV, dK) and the hi/lo fragments, 225 at d = 64 and 255, the most a
// thread may have, at d = 128. So two dk/dv blocks share an SM.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;   // rows of a q tile and of a kv tile: one wgmma M
constexpr int NT = 128;  // one warpgroup
using namespace wgmma_bf16;  // HALF, BOX_BYTES, wgmma_ss/rs, split_pair

// k-step kk (16 columns of d) of a tile read K-major: box kk / 4, 32 bytes
// into its swizzled rows.
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk / 4) * BOX_BYTES + (kk % 4) * 32, 16, 1024);
}

// k-step kk (16 rows, 2048 bytes) of a tile read MN-major through the
// transpose bit; a second box of d, if any, lies BOX_BYTES on.
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, BOX_BYTES, 1024);
}

// Rows [row, row + BM) of two [bh, rows, D] tensors into ``dst`` (``b``'s
// tile right after ``a``'s); the copies complete on ``bar``.
template <int D>
__device__ __forceinline__ void load_pair(const CUtensorMap* a,
                                          const CUtensorMap* b, uint32_t bar,
                                          uint32_t dst, int row, int bh) {
  constexpr uint32_t TILE = (D / HALF) * BOX_BYTES;
  mbar_expect_tx(bar, 2 * TILE);
#pragma unroll
  for (int h = 0; h < D / HALF; ++h) {
    tma_load(dst + h * BOX_BYTES, a, bar, h * HALF, row, bh);
    tma_load(dst + TILE + h * BOX_BYTES, b, bar, h * HALF, row, bh);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// A 64 x 64 accumulator as wgmma A fragments, split into bf16 hi and lo:
// register r of 16-column step kk holds the pair of accumulator elements
// 8kk + 2r and 8kk + 2r + 1.
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[BM / 16][4],
                                            uint32_t (&lo)[BM / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_pair(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r],
                 lo[kk][r]);
}

// This thread's rows (r0 and r0 + 8 of the tile at ``row0``) of a 64 x D
// accumulator, times ``scale``, to bf16 rows of ``out`` below ``n_rows``.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 2],
                                           int row0, int n_rows, int r0,
                                           int c0, float scale) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + 8 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + 8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale,
                                acc[4 * j + 2 * i + 1] * scale);
  }
}

// dk and dv of kv rows [k0, k0 + BM) of one (b, h), over the q tiles that
// see them.
template <int D, int STAGES>
__global__ void __launch_bounds__(NT)
bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap gmap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int s, int sk,
                     float sm_scale, int causal) {
  constexpr uint32_t TILE = (D / HALF) * BOX_BYTES;  // one 64-row tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[STAGES + 1];  // the ring's, then K/V's
  // swizzled boxes sit on 1024-byte boundaries: K, V, then (q, g) per slot
  const uint32_t k_smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t v_smem = k_smem + TILE;
  const uint32_t ring = v_smem + TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BM;
  // causal: from the q tile that holds row k0; kv rows that no query
  // reaches (k0 >= s) run no tile and write their zeros below
  const int first = causal ? k0 / BM : 0;
  const int n_tiles = max((s + BM - 1) / BM - first, 0);

  const uint32_t kv_bar = smem_u32(&bars[STAGES]);
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    load_pair<D>(&kmap, &vmap, kv_bar, k_smem, k0, bh);
    for (int t = 0; t < STAGES && t < n_tiles; ++t)
      load_pair<D>(&qmap, &gmap, smem_u32(&bars[t]), ring + 2 * TILE * t,
                   (first + t) * BM, bh);
  }

  // accumulator fragments: element 4j + 2i + c is row r0 + 8i, column
  // 8j + c0 + c
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const float* lse_b = lse + (size_t)bh * s;
  const float* delta_b = delta + (size_t)bh * s;
  float dk_acc[D / 2], dv_acc[D / 2];
  zero(dk_acc);
  zero(dv_acc);

  if (n_tiles > 0) mbar_wait(kv_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % STAGES;
    const uint32_t q_smem = ring + 2 * TILE * slot;
    const uint32_t g_smem = q_smem + TILE;
    const int i0 = (first + t) * BM;
    mbar_wait(smem_u32(&bars[slot]), (t / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns q rows
    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(st, k_major(k_smem, kk), k_major(q_smem, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dpt, k_major(v_smem, kk), k_major(g_smem, kk));
    wgmma_commit();
    // meanwhile, lse and delta of this thread's 16 q columns
    float lse_c[16], delta_c[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qp = i0 + 8 * j + c0 + c;
        const bool in = qp < s;  // rows at or past s: p = 0, nothing read
        lse_c[2 * j + c] = in ? lse_b[qp] : INFINITY;
        delta_c[2 * j + c] = in ? delta_b[qp] : 0.f;
      }
    }
    wgmma_wait0();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp(S^T * scale - lse), 0 where masked; dS^T = P^T (dP^T -
    // delta), both f32, in place
    const bool edge = k0 + BM > sk || (causal && i0 < k0 + BM - 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kp = k0 + r0 + 8 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          bool ok = true;
          if (edge) ok = kp < sk && (!causal || i0 + 8 * j + c0 + c >= kp);
          const float p =
              ok ? expf(st[e] * sm_scale - lse_c[2 * j + c]) : 0.f;
          st[e] = p;
          dpt[e] = p * (dpt[e] - delta_c[2 * j + c]);
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q: the contraction over this tile's q
    // rows, P^T and dS^T each as bf16 hi + lo
    uint32_t p_hi[BM / 16][4], p_lo[BM / 16][4];
    uint32_t ds_hi[BM / 16][4], ds_lo[BM / 16][4];
    split_frags(st, p_hi, p_lo);
    split_frags(dpt, ds_hi, ds_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      const uint64_t g_kk = mn_major(g_smem, kk);
      const uint64_t q_kk = mn_major(q_smem, kk);
      wgmma_rs(dv_acc, p_hi[kk], g_kk);
      wgmma_rs(dv_acc, p_lo[kk], g_kk);
      wgmma_rs(dk_acc, ds_hi[kk], q_kk);
      wgmma_rs(dk_acc, ds_lo[kk], q_kk);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dv_acc);
    fence_regs(dk_acc);

    __syncthreads();  // no warp reads this slot any more: refill it
    if (tid == 0 && t + STAGES < n_tiles)
      load_pair<D>(&qmap, &gmap, smem_u32(&bars[slot]), q_smem,
                   (first + t + STAGES) * BM, bh);
  }

  store_rows<D>(dk + (size_t)bh * sk * D, dk_acc, k0, sk, r0, c0, sm_scale);
  store_rows<D>(dv + (size_t)bh * sk * D, dv_acc, k0, sk, r0, c0, 1.f);
}

// dq of q rows [q0, q0 + BM) of one (b, h), over the kv tiles they see.
template <int D, int STAGES>
__global__ void __launch_bounds__(NT)
bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap gmap,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int s, int sk,
                   float sm_scale, int causal) {
  constexpr uint32_t TILE = (D / HALF) * BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[STAGES + 1];  // the ring's, then q/g's
  // q, g, then (K, V) per slot, on 1024-byte boundaries
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t g_smem = q_smem + TILE;
  const uint32_t ring = g_smem + TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest first

  int n_tiles = (sk + BM - 1) / BM;
  // causal: up to the kv tile that holds this tile's last row
  if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BM + 1);

  const uint32_t qg_bar = smem_u32(&bars[STAGES]);
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_pair<D>(&qmap, &gmap, qg_bar, q_smem, q0, bh);
    for (int t = 0; t < STAGES && t < n_tiles; ++t)
      load_pair<D>(&kmap, &vmap, smem_u32(&bars[t]), ring + 2 * TILE * t,
                   t * BM, bh);
  }

  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  // lse and delta of this thread's two rows (rows at or past s are not
  // written, and their lse is not read)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + r0 + 8 * i;
    lse_r[i] = qp < s ? lse[(size_t)bh * s + qp] : 0.f;
    delta_r[i] = qp < s ? delta[(size_t)bh * s + qp] : 0.f;
  }
  float dq_acc[D / 2];
  zero(dq_acc);

  mbar_wait(qg_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % STAGES;
    const uint32_t k_smem = ring + 2 * TILE * slot;
    const uint32_t v_smem = k_smem + TILE;
    mbar_wait(smem_u32(&bars[slot]), (t / STAGES) & 1);

    // S = Q K^T and dP = dO V^T: rows q, columns keys
    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, k_major(q_smem, kk), k_major(k_smem, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, k_major(g_smem, kk), k_major(v_smem, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - delta), P = exp(S * scale - lse), 0 where masked
    const int k0 = t * BM;
    const bool edge = k0 + BM > sk || (causal && k0 + BM - 1 > q0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = q0 + r0 + 8 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          const int kp = k0 + 8 * j + c0 + c;
          bool ok = true;
          if (edge) ok = kp < sk && (!causal || qp >= kp);
          const float p = ok ? expf(sc[e] * sm_scale - lse_r[i]) : 0.f;
          dp[e] = p * (dp[e] - delta_r[i]);
        }
      }
    }

    // dQ += dS K: the contraction over this tile's keys, dS as bf16 hi + lo
    uint32_t ds_hi[BM / 16][4], ds_lo[BM / 16][4];
    split_frags(dp, ds_hi, ds_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      const uint64_t k_kk = mn_major(k_smem, kk);
      wgmma_rs(dq_acc, ds_hi[kk], k_kk);
      wgmma_rs(dq_acc, ds_lo[kk], k_kk);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dq_acc);

    __syncthreads();  // no warp reads this slot any more: refill it
    if (tid == 0 && t + STAGES < n_tiles)
      load_pair<D>(&kmap, &vmap, smem_u32(&bars[slot]), k_smem,
                   (t + STAGES) * BM, bh);
  }

  store_rows<D>(dq + (size_t)bh * s * D, dq_acc, q0, s, r0, c0, sm_scale);
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, s, sk;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <int D, int STAGES>
int launch(bool dkdv, const Args& a) {
  CUtensorMap qmap, kmap, vmap, gmap;
  const CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = tensor_map(&qmap, type, 2, a.q, a.bh, a.s, D);
  if (err == 0) err = tensor_map(&kmap, type, 2, a.k, a.bh, a.sk, D);
  if (err == 0) err = tensor_map(&vmap, type, 2, a.v, a.bh, a.sk, D);
  if (err == 0) err = tensor_map(&gmap, type, 2, a.g, a.bh, a.s, D);
  if (err != 0) return err;
  // two resident tiles and the ring's pairs, plus the slack to align them
  // to 1024 bytes
  const int bytes = (int)((D / HALF) * BOX_BYTES * (2 + 2 * STAGES)) + 1024;
  cudaError_t attr;
  if (dkdv) {
    attr = cudaFuncSetAttribute(bwd_dkdv_sm90_kernel<D, STAGES>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid(a.bh, (a.sk + BM - 1) / BM);
    bwd_dkdv_sm90_kernel<D, STAGES><<<grid, NT, bytes, a.stream>>>(
        qmap, kmap, vmap, gmap, a.lse, a.delta,
        static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
        a.s, a.sk, a.sm_scale, a.causal);
  } else {
    attr = cudaFuncSetAttribute(bwd_dq_sm90_kernel<D, STAGES>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid(a.bh, (a.s + BM - 1) / BM);
    bwd_dq_sm90_kernel<D, STAGES><<<grid, NT, bytes, a.stream>>>(
        qmap, kmap, vmap, gmap, a.lse, a.delta,
        static_cast<__nv_bfloat16*>(a.dq), a.s, a.sk, a.sm_scale, a.causal);
  }
  return (int)cudaGetLastError();
}

int run(bool dkdv, const Args& a, int d) {
  if (a.bh <= 0 || a.s <= 0 || a.sk <= 0 || (a.s + BM - 1) / BM > 65535 ||
      (a.sk + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (d == 64) return launch<64, 3>(dkdv, a);
  if (d == 128) return launch<128, 2>(dkdv, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The caller has checked shapes, bf16, contiguity, 16-byte alignment and
// d in {64, 128}, and allocated lse and delta (f32 [bh, s]: the forward's
// lse, bwd_delta's delta) and the gradients. Each returns 0 on success,
// else a CUDA error (after the launch, cudaGetLastError()) or one of
// hopper.cuh's tensor-map codes; neither allocates or synchronises.
extern "C" int edl_flash_bwd_dq_sm90(const void* q, const void* k,
                                     const void* v, const void* g,
                                     const float* lse, const float* delta,
                                     void* dq, int bh, int s, int sk, int d,
                                     float sm_scale, int causal,
                                     void* stream) {
  const Args a{q,  k,  v,  g, lse,      delta,  dq,
               nullptr, nullptr, bh, s, sk, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  return run(false, a, d);
}

extern "C" int edl_flash_bwd_dkdv_sm90(const void* q, const void* k,
                                       const void* v, const void* g,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv, int bh, int s,
                                       int sk, int d, float sm_scale,
                                       int causal, void* stream) {
  const Args a{q,  k,  v,  g,  lse, delta, nullptr,
               dk, dv, bh, s, sk, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  return run(true, a, d);
}

extern "C" const char* edl_flash_bwd_sm90_error_string(int err) {
  return error_string(err);
}
