// Flash-attention forward for Hopper (sm_90a) on float32 at head_dim 64:
// O = softmax(mask(q * scale . k^T)) . v, both products on the tensor cores
// as TF32 wgmma, held to f32 accuracy by a 3xTF32 split.
//
// Replaces, for f32 at head_dim 64 (lm_teacher's prefills and lm predicts),
// the two Pallas TPU kernels of edl_tpu/ops/flash_attention.py:
// _fwd_kernel_resident (:82) and the streaming _fwd_kernel (:30). It
// computes their function: q scaled by sm_scale in f32 before the product,
// the causal diagonal anchored at position 0 (q row i sees keys 0..i), keys
// at or beyond sk masked, masked scores -1e30 and their probabilities 0, an
// f32 online softmax, output acc / max(l, 1e-30). flash_fwd_sm90.cu serves
// bf16 at head_dim 64/128 and flash_fwd.cu (f32 FFMA) the rest;
// ops/flash_attention.py picks one of the three before launch (kernel_for).
//
// Layout: q, o are [bh, s, 64]; k, v are [bh, sk, 64]; contiguous f32,
// 16-byte aligned. lse, when not NULL, is f32 [bh, s]: each row's m +
// log(max(l, 1e-30)) over the scaled, masked scores, for the backward
// (csrc/flash_bwd.cu). Rows at or past s are not written.
//
// TF32 by design. The tensor cores multiply TF32 (a 10-bit mantissa), which
// alone keeps about 3 decimal digits and misses chip_smoke.py's f32 check
// (1e-5 + 1e-5 |ref|; tests/test_torch_flash_numerics.py emulates both).
// So every operand x is split into hi = cvt.rna.tf32(x) and lo = x - hi
// (exact in f32; the tensor core reads its top 19 bits), and each product
// is three wgmmas: hi.hi into one f32 accumulator, lo.hi + hi.lo into
// another, added on the CUDA cores. What is left out, lo.lo and lo's
// truncation, is about 2^-21 of each term. The tensor cores' f32 sums
// drop the bits they shift out (they round toward zero), so no sum runs
// long there: both accumulators start from zero on every kv tile, S's
// chain of hi.hi wgmmas is 8 long, and the running output acc is
// rescaled and summed on the CUDA cores (acc = acc * corr + P V). One
// accumulator carried over all tiles on the tensor cores missed the
// check by 12.5x at sk = 16640 (chip_smoke.py's K2 case): the dropped
// bits add up. The kernel uses TF32 this way whatever
// torch.backends.cuda.matmul.allow_tf32 says: that flag governs PyTorch's
// own matmuls, not this kernel.
//
// Design. One warpgroup (128 threads) per (b*h, 64-row q tile):
// - TMA copies the q tile once, and 64-row K and V tiles into a ring of
//   STAGES slots, each slot with an mbarrier that its copy completes, so the
//   next tiles load while this one is in the tensor cores. The tensor maps
//   are 3-D [bh, rows, 64]: rows at or beyond s or sk come in as zeros, and
//   scores of keys at or beyond sk are still masked. A tile is two boxes of
//   64 rows x 32 floats (128 bytes), 128-byte swizzled, the K-major layout
//   that wgmma's descriptors read.
// - q is scaled and split in place once: Q_hi and Q_lo, same layout.
// - A split pass per kv tile, by all 128 threads, writes K_hi and K_lo
//   (elementwise: the swizzled layout is kept) and V^T_hi and V^T_lo.
//   TF32 wgmma takes B K-major only, and for P.V the reduction runs over
//   keys, so V [kv, d] is transposed into [d, kv] rows, 128-byte swizzled.
// - S = Q K^T is 3 x 8 wgmma m64n64k8 from shared memory.
// - The online softmax is f32 in registers; a row reduces over the four
//   threads of a quad by shuffles.
// - P V is 3 x 8 wgmma m64n64k8 with P (split in registers) as the A
//   operand. The accumulator leaves thread (group g, lane-in-quad t) the
//   keys 2t and 2t + 1 of each 8-key step; the TF32 A fragment wants keys t
//   and t + 4 there. A sum over keys does not care about their order, so
//   the transpose stores the keys of each group of 8 as 0 2 4 6 1 3 5 7, and
//   P is used where it lies.
// - Causal q tiles launch from the last (the longest kv loop) to the first,
//   and each kv loop stops at the tile that holds its diagonal.
//
// What bounds it. At lm_teacher's longest prefill (b*h = 12, s = sk = 1024,
// causal) the function reads q, k, v and writes o once: 12.6 MB, 3.76 us at
// 3.35 TB/s. Its two products are 1.61 GFLOP: 24.1 us on the CUDA cores'
// 67 TFLOP/s f32, 9.77 us as three TF32 passes at 495 TFLOP/s. So the
// operations bound it, and the split triples them. What holds this design
// back: one warpgroup runs the split pass, both products and the softmax in
// turn, with a barrier after the split and after P.V, so the tensor cores
// idle while the CUDA cores split and exponentiate; the 160 KB of shared
// memory (Q hi/lo 32 KB, two raw K/V stages 64 KB, the split K/V^T 64 KB)
// leave one block per SM, so no other block fills those gaps; K/V tiles are
// split again for every q tile that reads them. Producer and consumer
// warpgroups, and a split done once per K/V tile, are the next steps.

#include "hopper.cuh"

namespace {

constexpr int BM = 64;    // q rows per block: one wgmma M
constexpr int BN = 64;    // kv rows per tile
constexpr int D = 64;     // head_dim
constexpr int NT = 128;   // one warpgroup
constexpr int COLS = 32;  // f32 columns in one 128-byte swizzled row
constexpr int STAGES = 2;
constexpr uint32_t BOX_BYTES = 64 * 128;  // one 64-row x 32-column box
constexpr uint32_t TILE = 2 * BOX_BYTES;  // one 64 x 64 f32 tile
constexpr float kNegInf = -1e30f;

// x rounded to TF32, to nearest with ties away from zero; the mask keeps
// the 13 bits below TF32's mantissa zero whatever cvt leaves there.
__device__ __forceinline__ float tf32_hi(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// What the TF32 rounding ``hi`` leaves of x (exact in f32).
__device__ __forceinline__ float tf32_lo(float x, float hi) { return x - hi; }

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  hi = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
  lo = make_float4(tf32_lo(x.x, hi.x), tf32_lo(x.y, hi.y),
                   tf32_lo(x.z, hi.z), tf32_lo(x.w, hi.w));
}

// d = a . b + (accumulate ? d : 0), m64n64k8 TF32, a and b from shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = a . b + (accumulate ? d : 0), m64n64k8 TF32, a from registers
// (element r of thread (g, t) of warp w: row 16w + g + 8 (r & 1), column
// t + 4 (r >> 1)), b from shared memory K-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// Tile ``t``'s K and V boxes into ring slot ``k_smem`` (V right after K).
__device__ __forceinline__ void load_kv(const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, uint32_t bar,
                                        uint32_t k_smem, int t, int bh) {
  mbar_expect_tx(bar, 2 * TILE);
#pragma unroll
  for (int h = 0; h < D / COLS; ++h) {
    tma_load(k_smem + h * BOX_BYTES, kmap, bar, h * COLS, t * BN, bh);
    tma_load(k_smem + TILE + h * BOX_BYTES, vmap, bar, h * COLS, t * BN, bh);
  }
}

// Byte offset of element (row, column) in a 64-row tile of 64 floats laid
// out as two 128-byte-swizzled boxes of 32 columns.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return (col / COLS) * BOX_BYTES + row * 128 +
         ((((col % COLS) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2);
}

__global__ void __launch_bounds__(NT, 1)
flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        float* __restrict__ o, float* __restrict__ lse, int s,
                        int sk, float sm_scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[STAGES + 1];  // the ring's, then q's
  // swizzled boxes sit on 1024-byte boundaries: Q hi/lo, K hi/lo, V^T
  // hi/lo, then K/V per ring slot
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t q_hi = base, q_lo = base + TILE;
  const uint32_t k_hi = base + 2 * TILE, k_lo = base + 3 * TILE;
  const uint32_t vt_hi = base + 4 * TILE, vt_lo = base + 5 * TILE;
  const uint32_t ring = base + 6 * TILE;
  auto at = [&](uint32_t addr) { return gbase + (addr - base); };

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
    for (int h = 0; h < D / COLS; ++h)
      tma_load(q_hi + h * BOX_BYTES, &qmap, q_bar, h * COLS, q0, bh);
    for (int t = 0; t < STAGES && t < n_tiles; ++t)
      load_kv(&kmap, &vmap, smem_u32(&bars[t]), ring + 2 * TILE * t, t, bh);
  }

  // q * sm_scale in f32, then split in place (elementwise, so the swizzled
  // layout is kept)
  mbar_wait(q_bar, 0);
  {
    float4* qh = reinterpret_cast<float4*>(at(q_hi));
    float4* ql = reinterpret_cast<float4*>(at(q_lo));
#pragma unroll
    for (int i = tid; i < (int)(TILE / 16); i += NT) {
      float4 x = qh[i];
      x.x *= sm_scale; x.y *= sm_scale; x.z *= sm_scale; x.w *= sm_scale;
      split4(x, qh[i], ql[i]);
    }
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

  // this thread's share of the V transpose: column n of V, keys 32 vh ..
  // 32 vh + 31
  const int vn = tid & 63;
  const int vh = tid >> 6;

  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % STAGES;
    const uint32_t k_raw = ring + 2 * TILE * slot;
    const uint32_t v_raw = k_raw + TILE;
    mbar_wait(smem_u32(&bars[slot]), (t / STAGES) & 1);

    // the split pass; the last tile's wgmmas are done with these buffers
    {
      const float4* kr = reinterpret_cast<const float4*>(at(k_raw));
      float4* kh = reinterpret_cast<float4*>(at(k_hi));
      float4* kl = reinterpret_cast<float4*>(at(k_lo));
#pragma unroll
      for (int i = tid; i < (int)(TILE / 16); i += NT)
        split4(kr[i], kh[i], kl[i]);
      const uint8_t* vr = at(v_raw);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int j0 = 32 * vh + 8 * g;
        float x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          x[e] = *reinterpret_cast<const float*>(vr + swz(j0 + e, vn));
        // keys 0 2 4 6 into positions j0 .. j0 + 3, keys 1 3 5 7 after
        float4 hi, lo;
        split4(make_float4(x[0], x[2], x[4], x[6]), hi, lo);
        *reinterpret_cast<float4*>(at(vt_hi) + swz(vn, j0)) = hi;
        *reinterpret_cast<float4*>(at(vt_lo) + swz(vn, j0)) = lo;
        split4(make_float4(x[1], x[3], x[5], x[7]), hi, lo);
        *reinterpret_cast<float4*>(at(vt_hi) + swz(vn, j0 + 4)) = hi;
        *reinterpret_cast<float4*>(at(vt_lo) + swz(vn, j0 + 4)) = lo;
      }
    }
    fence_proxy_async();
    __syncthreads();  // split done: the wgmmas may read it, the slot refill
    if (tid == 0 && t + STAGES < n_tiles)
      load_kv(&kmap, &vmap, smem_u32(&bars[slot]), k_raw, t + STAGES, bh);

    // S: hi.hi into sc, the lo terms into sc_lo, each from zero (the first
    // wgmma of a chain does not read its accumulator)
    float sc[BN / 2], sc_lo[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      // 8 columns of d: box kk / 4, 32 bytes into its swizzled rows
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      const uint64_t dqh = desc_sw128(q_hi + off, 16, 1024);
      const uint64_t dkh = desc_sw128(k_hi + off, 16, 1024);
      wgmma_ss(sc_lo, desc_sw128(q_lo + off, 16, 1024), dkh, kk > 0);
      wgmma_ss(sc_lo, dqh, desc_sw128(k_lo + off, 16, 1024), 1);
      wgmma_ss(sc, dqh, dkh, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(sc_lo);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] += sc_lo[i];

    const int k0 = t * BN;
    const bool edge = k0 + BN > sk || (causal && k0 + BN - 1 > q0);
    float corr[2];
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
          x = ok ? x : kNegInf;
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
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + row_sum;
      m[i] = m_new;
    }

    // P as TF32 A fragments of 8-key step kk: elements (row g, key 2t),
    // (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1) stand at the fragment's
    // columns t and t + 4, where V^T holds those keys
    uint32_t p_hi[BN / 8][4], p_lo[BN / 8][4];
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      const float f[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1],
                          sc[4 * kk + 3]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float hi = tf32_hi(f[r]);
        p_hi[kk][r] = __float_as_uint(hi);
        p_lo[kk][r] = __float_as_uint(tf32_lo(f[r], hi));
      }
    }

    // this tile's P V from zero (hi.hi and the lo terms apart), added to
    // the rescaled acc on the CUDA cores
    float pv[D / 2], pv_lo[D / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      // 8 keys: box kk / 4, 32 bytes into its swizzled rows
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      const uint64_t dvh = desc_sw128(vt_hi + off, 16, 1024);
      wgmma_rs(pv_lo, p_lo[kk], dvh, kk > 0);
      wgmma_rs(pv_lo, p_hi[kk], desc_sw128(vt_lo + off, 16, 1024), 1);
      wgmma_rs(pv, p_hi[kk], dvh, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(pv);
    fence_regs(pv_lo);
    // element e of a fragment lies in row r0 + 8 ((e >> 1) & 1)
#pragma unroll
    for (int e = 0; e < D / 2; ++e)
      acc[e] = acc[e] * corr[(e >> 1) & 1] + (pv[e] + pv_lo[e]);
    __syncthreads();  // no warp reads the split buffers any more
  }

  float* ob = o + (size_t)bh * s * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + r0 + 8 * i;
    if (qp >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // the quad's four lanes hold the row's m and l: one stores them
    if (lse != nullptr && (lane & 3) == 0)
      lse[(size_t)bh * s + qp] = m[i] + logf(denom);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(ob + (size_t)qp * D + 8 * j + c0) =
          make_float2(acc[4 * j + 2 * i] / denom,
                      acc[4 * j + 2 * i + 1] / denom);
  }
}

}  // namespace

// The caller has checked shapes, f32, contiguity, 16-byte alignment and
// d == 64, and allocated lse (f32 [bh, s]) or passes NULL for none. Returns
// 0 on success, else a CUDA error (after the launch, cudaGetLastError()) or
// one of hopper.cuh's tensor-map codes; allocates nothing and does not
// synchronise.
extern "C" int edl_flash_fwd_tf32x3(const void* q, const void* k,
                                    const void* v, void* o, float* lse,
                                    int bh, int s, int sk, int d,
                                    float sm_scale, int causal,
                                    void* stream) {
  if (bh <= 0 || s <= 0 || sk <= 0 || d != D || (s + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = tensor_map(&qmap, f32, 4, q, bh, s, D);
  if (err == 0) err = tensor_map(&kmap, f32, 4, k, bh, sk, D);
  if (err == 0) err = tensor_map(&vmap, f32, 4, v, bh, sk, D);
  if (err != 0) return err;
  // Q, K, V^T hi/lo and the ring, plus the slack to align them to 1024 bytes
  const int bytes = (int)(TILE * (6 + 2 * STAGES)) + 1024;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(bh, (s + BM - 1) / BM);
  flash_fwd_tf32x3_kernel<<<grid, NT, bytes, static_cast<cudaStream_t>(
                                                stream)>>>(
      qmap, kmap, vmap, static_cast<float*>(o), lse, s, sk, sm_scale,
      causal);
  return (int)cudaGetLastError();
}

extern "C" const char* edl_flash_tf32x3_error_string(int err) {
  return error_string(err);
}
