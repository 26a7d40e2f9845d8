// Flash-attention forward for Hopper (sm_90a) on bf16 at head_dim 64 or 128:
// O = softmax(mask(q . k^T * scale)) . v, on the tensor cores.
//
// Replaces, for the served bf16 path, the two Pallas TPU kernels of
// edl_tpu/ops/flash_attention.py: _fwd_kernel_resident (:82) and the
// streaming _fwd_kernel (:30). It computes their function: the causal
// diagonal anchored at position 0 (q row i sees keys 0..i), keys at or
// beyond sk masked, masked scores -1e30 and their probabilities 0, an f32
// online softmax, output acc / max(l, 1e-30). csrc/flash_fwd_tf32x3.cu is
// the kernel for f32 at head_dim 64 and csrc/flash_fwd.cu for the rest;
// ops/flash_attention.py picks one of the three before launch (kernel_for).
//
// Layout: q, o are [bh, s, d]; k, v are [bh, sk, d]; contiguous bf16,
// 16-byte aligned; d is 64 or 128.
//
// Design. One warpgroup (128 threads) per (b*h, 64-row q tile):
// - TMA copies q once and K/V 64-row tiles into a ring of STAGES slots in
//   shared memory, each slot with an mbarrier that the copy completes, so
//   the next tiles load while this one is in the tensor cores. The tensor
//   maps are 3-D [bh, rows, d]: rows at or beyond s or sk come in as zeros
//   (a flattened [bh*rows, d] map would read the next head's rows there),
//   and scores of keys at or beyond sk are still masked to -1e30. Boxes are
//   64 rows by 64 columns (128 bytes) with the 128-byte swizzle that wgmma's
//   descriptors read; d = 128 takes two boxes per tile.
// - S = q k^T is wgmma m64n64k16 from shared memory: q is A and K, stored
//   [n, d], is B in its K-major form. A bf16 x bf16 product is exact in f32,
//   so this keeps the reference's f32 upcast up to the order of the sums.
//   sm_scale multiplies the f32 scores after the product (exact at d = 64,
//   one f32 rounding from the reference otherwise).
// - The online softmax (row max, correction, l) is f32 in registers; each
//   thread holds two rows of the accumulator fragment, and a row reduces
//   over the four threads of a quad by shuffles.
// - O += P v is wgmma m64nDk16 with P as the A operand in registers and V,
//   stored [n, d], read through the descriptor's transpose bit. P is split:
//   P_hi = bf16(P) and P_lo = bf16(P - P_hi), two wgmmas into the same f32
//   accumulator. Why: the reference multiplies f32 P by v. Rounding P once
//   to bf16 misses chip_smoke.py's check (1e-4 + 2^-7 |ref|): the emulation
//   in tests/test_torch_flash_numerics.py, at the smoke's inputs
//   (b4 h12 d64), puts the worst |out - ref| - 2^-7 |ref| at 26.6x the atol
//   for s = sk = 1024 causal, 17.5x full, 28.1x ragged s = sk = 1000 causal,
//   28.2x at sk = 24 and 13.1x at s = 100, sk = 1000. With the split it is
//   0.010x to 0.026x. The split doubles the P v products, which the tensor
//   cores have to spare here.
// - Causal q tiles launch from the last (the longest kv loop) to the first,
//   so the long tiles do not form a tail, and each tile's kv loop stops at
//   the tile that holds its diagonal. Only tiles that cross the diagonal or
//   sk build the mask.
//
// What bounds it. At the served shape (b*h = 48, s = sk = 1024, d = 64,
// causal) the function moves 25.2 MB (q, k, v read once, o written once):
// 7.51 us at 3.35 TB/s, against 6.52 us for its 6.45 GFLOP at 989 TFLOP/s
// bf16, so the bound is bytes. With the split, P v costs twice, which puts
// the tensor-core work (about 9.7 GFLOP) above the byte bound. What holds
// this design back: one warpgroup starts the copies, waits, runs both
// products and the softmax in turn, so the tensor cores idle during the
// softmax and the expf calls; a __syncthreads ends every kv tile before its
// slot is refilled; each block reads its K/V tiles from L2 again for every
// q tile; the output leaves from registers with 4-byte stores. Producer and
// consumer warpgroups (warp specialisation), persistent blocks and a TMA
// store of O are the next steps.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;     // q rows per block: one wgmma M
constexpr int BN = 64;     // kv rows per tile
constexpr int NT = 128;    // one warpgroup
constexpr float kNegInf = -1e30f;
using namespace wgmma_bf16;  // HALF, BOX_BYTES, wgmma_ss/rs, split_pair

// Tile ``t``'s K and V boxes into ring slot ``k_smem`` (V right after K).
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, uint32_t bar,
                                        uint32_t k_smem, int t, int bh) {
  constexpr uint32_t TILE = (D / HALF) * BOX_BYTES;
  mbar_expect_tx(bar, 2 * TILE);
#pragma unroll
  for (int h = 0; h < D / HALF; ++h) {
    tma_load(k_smem + h * BOX_BYTES, kmap, bar, h * HALF, t * BN, bh);
    tma_load(k_smem + TILE + h * BOX_BYTES, vmap, bar, h * HALF, t * BN, bh);
  }
}

template <int D, int STAGES>
__global__ void __launch_bounds__(NT)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      __nv_bfloat16* __restrict__ o, int s, int sk,
                      float sm_scale, int causal) {
  constexpr uint32_t TILE = (D / HALF) * BOX_BYTES;  // one 64-row tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[STAGES + 1];  // the ring's, then q's
  // swizzled boxes sit on 1024-byte boundaries: q, then K/V per slot
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = q_smem + TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest first

  int n_tiles = (sk + BN - 1) / BN;
  if (causal) {
    // the last kv tile that holds a key at or left of this tile's last row
    const int last = (q0 + BM - 1) / BN + 1;
    n_tiles = min(n_tiles, last);
  }

  const uint32_t q_bar = smem_u32(&bars[STAGES]);
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, TILE);
    for (int h = 0; h < D / HALF; ++h)
      tma_load(q_smem + h * BOX_BYTES, &qmap, q_bar, h * HALF, q0, bh);
    for (int t = 0; t < STAGES && t < n_tiles; ++t)
      load_kv<D>(&kmap, &vmap, smem_u32(&bars[t]), ring + 2 * TILE * t, t,
                 bh);
  }

  // accumulator fragments: element 4j + 2i + c is row r0 + 8i, column
  // 8j + c0 + c
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % STAGES;
    const uint32_t k_smem = ring + 2 * TILE * slot;
    const uint32_t v_smem = k_smem + TILE;
    mbar_wait(smem_u32(&bars[slot]), (t / STAGES) & 1);

    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // 16 columns of d: box kk / 4, 32 bytes into its swizzled rows
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss(sc, desc_sw128(q_smem + off, 16, 1024),
               desc_sw128(k_smem + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    const int k0 = t * BN;
    const bool edge = k0 + BN > sk || (causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = q0 + r0 + 8 * i;
      bool keep[BN / 4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kp = k0 + 8 * j + c0 + c;
          float& x = sc[4 * j + 2 * i + c];
          bool ok = true;
          if (edge) ok = kp < sk && (!causal || qp >= kp);
          keep[2 * j + c] = ok;
          x = ok ? x * sm_scale : kNegInf;
          row_max = fmaxf(row_max, x);
        }
      }
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sc[4 * j + 2 * i + c];
          x = keep[2 * j + c] ? expf(x - m_new) : 0.f;
          row_sum += x;
        }
      }
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < D / 4; ++e) acc[4 * (e / 2) + 2 * i + e % 2] *= corr;
    }

    // P as wgmma A fragments: register r of 16-key step kk holds the pair
    // of accumulator elements 8kk + 2r and 8kk + 2r + 1
    uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_pair(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], p_hi[kk][r],
                   p_lo[kk][r]);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      // 16 kv rows: 2048 bytes on; D = 128's second box BOX_BYTES away
      const uint64_t dv = desc_sw128(v_smem + kk * 2048, BOX_BYTES, 1024);
      wgmma_rs(acc, p_hi[kk], dv);
      wgmma_rs(acc, p_lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);

    __syncthreads();  // no warp reads this slot any more: refill it
    if (tid == 0 && t + STAGES < n_tiles)
      load_kv<D>(&kmap, &vmap, smem_u32(&bars[slot]), k_smem, t + STAGES,
                 bh);
  }

  __nv_bfloat16* ob = o + (size_t)bh * s * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + r0 + 8 * i;
    if (qp >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qp * D + 8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] / denom,
                                acc[4 * j + 2 * i + 1] / denom);
  }
}

template <int D, int STAGES>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, int sk, float sm_scale, int causal, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = tensor_map(&qmap, bf16, 2, q, bh, s, D);
  if (err == 0) err = tensor_map(&kmap, bf16, 2, k, bh, sk, D);
  if (err == 0) err = tensor_map(&vmap, bf16, 2, v, bh, sk, D);
  if (err != 0) return err;
  // q and the ring, plus the slack to align them to 1024 bytes
  const int bytes = (int)((D / HALF) * BOX_BYTES * (1 + 2 * STAGES)) + 1024;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(bh, (s + BM - 1) / BM);
  flash_fwd_sm90_kernel<D, STAGES><<<grid, NT, bytes, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), s, sk, sm_scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// The caller has checked shapes, bf16, contiguity, 16-byte alignment and
// d in {64, 128}. Returns 0 on success, else a CUDA error (after the launch,
// cudaGetLastError()) or one of hopper.cuh's tensor-map codes; allocates
// nothing and does not synchronise.
extern "C" int edl_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                  void* o, int bh, int s, int sk, int d,
                                  float sm_scale, int causal, void* stream) {
  if (bh <= 0 || s <= 0 || sk <= 0 || (s + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64, 3>(q, k, v, o, bh, s, sk, sm_scale, causal, st);
  if (d == 128)
    return launch<128, 2>(q, k, v, o, bh, s, sk, sm_scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* edl_flash_sm90_error_string(int err) {
  return error_string(err);
}
