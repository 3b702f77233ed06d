// Grouped matmul (MoE expert GEMM) for Hopper (sm_90a), plain C interface.
//
// Replaces: sutro_tpu/ops/pallas_gmm.py::grouped_matmul (kernel body
// _gmm_kernel). out[i] = lhs[i] @ rhs[g(i)] for rows sorted by group, the
// contract of jax.lax.ragged_dot: lhs [M, H] bf16, rhs [E, H, F] bf16,
// group_sizes [E] int32 (sum <= M; empty groups allowed), out [M, F] bf16,
// f32 accumulation; rows past the last group are zero.
//
// One kernel for every M: 128 x 256 output tiles of one expert on wgmma,
// fed by TMA. What bounds it on this card:
//
// - at decode sizes (M = B * top_k = 512 rows over 21-126 of 128
//   experts, a handful of rows each) bytes: every routed expert's [H, F]
//   weights read once. Wide tiles read each weight slab in few, long
//   TMA boxes; the lhs box of a tile past its expert's few rows costs
//   L2 reads only.
// - at prefill sizes (M in the thousands, tens to hundreds of rows per
//   expert) both limits are close: at M = 32,768 and qwen3-30b-a3b's
//   widths ~0.18 ms for the 0.59 GB the call must move and ~0.10 ms for
//   its 103 GFLOP at the H100 SXM's published peaks; with 128-row tiles
//   every weight slab and lhs row is re-read by several blocks, so the
//   L2 cache's bandwidth and the tensor cores' instruction rate bind
//   before device memory does.
//
// Decode sizes need no kernel of their own: on an NVIDIA H100 80GB HBM3
// at 700 W this one is faster than a 64 x 128 nvcuda::wmma kernel at
// every M measured, from 24 rows to 32,768 (0.134 against 0.149 ms at a
// decode step's 512 rows over ~121 experts, 0.035 against 0.073 over
// 21; PERF.md).
//
// The design: a 4-stage shared-memory ring of 64-deep stages (48 KB
// each) filled by TMA with 128-byte swizzle and full/empty mbarrier
// pairs; one producer warp (registers given up with setmaxnreg) starts
// the loads, two consumer warpgroups each run wgmma.mma_async.m64n256k16
// on 64 rows with the f32 accumulators in registers, convert them to
// bf16 in registers, stage the tile in the ring once both are done
// reading it and store the valid rows in 16-byte pieces (bf16 pairs
// stored straight from the accumulators measured slower). rhs's [H, F]
// slabs are row-major (N-major B): wgmma reads them through its
// transpose bit, so the weights are never copied to another layout. The
// tensor maps are encoded on the host for each call; the lhs box of a
// tile that ends inside its expert loads the next expert's rows, which
// the store masks; a box past M or H is zero-filled by TMA. Blocks run
// expert by expert, and within an expert column slab by column slab, so
// the row tiles that re-read a weight slab run together and find it in
// L2. (A persistent variant, one block an SM striding over the tiles,
// measured slower at M >= 16,384: the blocks drift apart and the slabs
// leave L2.)
//
// The group sizes stay on the device. The grid has the static row-tile
// bound ceil(M / BM) + E (each group adds at most one partial tile);
// each block stages the device-side group sizes in shared memory in one
// round of loads, warp 0 scans them into a tile table, and every warp
// finds its expert, first row and row count there; a block past the last
// tile zeroes up to BM rows past the last group and exits. So a tile
// never spans two experts' weights and no host wait sizes the launch.

#include <cuda.h>  // CUtensorMap and its encoder's types; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- the tile -> expert scan

struct TileInfo {
  int expert;  // < 0: a block past the last tile, which zeroes rows
  int row0;    // first row of the tile
  int rows;    // rows of the tile (<= BM)
  int col0;    // first output column
};

constexpr int MAX_EXPERTS = 1024;

// The block's tile table, built from the device-side sizes: for expert
// e, tiles [ts[e], ts[e+1]) of BM rows from row rs[e]. Called by every
// thread: the sizes are staged in rs with one round of loads, then warp
// 0 scans them in place (each lane reads its expert's size before it
// writes that expert's row).
template <int BM>
__device__ void build_table(const int32_t* __restrict__ group_sizes, int E, int* ts, int* rs) {
  for (int e = threadIdx.x; e < E; e += blockDim.x) rs[e] = max(group_sizes[e], 0);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int tile_base = 0, row_base = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const int gs = e < E ? rs[e] : 0;
      const int nt = (gs + BM - 1) / BM;
      int ct = nt, cr = gs;  // inclusive scans over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, ct, o);
        const int y = __shfl_up_sync(0xffffffffu, cr, o);
        if (lane >= o) { ct += x; cr += y; }
      }
      if (e < E) ts[e] = tile_base + ct - nt, rs[e] = row_base + cr - gs;
      tile_base += __shfl_sync(0xffffffffu, ct, 31);
      row_base += __shfl_sync(0xffffffffu, cr, 31);
    }
    if (lane == 0) ts[E] = tile_base, rs[E] = row_base;
  }
  __syncthreads();
}

// Tile `id` from the table, in every lane of the calling warp. Tiles run
// expert by expert; an expert's nt row tiles x n_col column slabs run
// slab by slab, each slab's row tiles together. Past the experts' tiles,
// a tile zeroes rows past the last group, BM rows x one slab (the
// static bound (ceil(M / BM) + E) * n_col leaves enough such tiles).
template <int BM, int BN>
__device__ TileInfo locate(const int* ts, const int* rs, int E, int M, int n_col, int id) {
  const int lane = threadIdx.x % 32;
  if (id >= ts[E] * n_col) {
    const int z = id - ts[E] * n_col, r0 = rs[E] + z / n_col * BM;
    return TileInfo{-1, r0, max(0, min(BM, M - r0)), z % n_col * BN};
  }
  int e = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int c = e0 + lane;
    const unsigned hit =
        __ballot_sync(0xffffffffu, c < E && id >= ts[c] * n_col && id < ts[c + 1] * n_col);
    if (hit) { e = e0 + __ffs(hit) - 1; break; }
  }
  const int nt = ts[e + 1] - ts[e], local = id - ts[e] * n_col, i = local % nt;
  const int r0 = rs[e] + i * BM;
  return TileInfo{e, r0, max(0, min(min(BM, rs[e + 1] - r0), M - r0)), local / nt * BN};
}

// zeros in a tile's rows and columns (rows past the last group), thread
// `c0` of `n` 16 bytes at a time
template <int BN>
__device__ void zero_rows(__nv_bfloat16* __restrict__ out, const TileInfo& t, int F, int c0,
                          int n) {
  for (int c = c0; c < t.rows * (BN / 8); c += n) {
    const int r = c / (BN / 8), nc = t.col0 + (c % (BN / 8)) * 8;
    if (nc < F)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(t.row0 + r) * F + nc) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

constexpr int BM = 128;                    // rows: two consumer warpgroups of 64
constexpr int BN = 256;                    // output columns
constexpr int BK = 64;                     // depth of a stage: one 128-byte row of bf16
constexpr int STAGES = 4;
constexpr int B_BOX = 64;                  // columns of one B box (128 bytes)
constexpr int A_BYTES = BM * BK * 2;       // 16 KB: [128 rows][64 k], swizzled
constexpr int B_BOX_BYTES = BK * B_BOX * 2;  // 8 KB: [64 k][64 n], swizzled
constexpr int STAGE_BYTES = A_BYTES + (BN / B_BOX) * B_BOX_BYTES;  // 48 KB
constexpr int THREADS = 384;               // producer warpgroup + 2 consumer warpgroups
constexpr int EPI_ROW = BN + 8;            // padded bf16 row of the epilogue's tile
static_assert(BM * EPI_ROW * 2 <= STAGES * STAGE_BYTES, "the epilogue tile fits in the ring");
// the ring, the tile table (2 x (E + 1) ints) and slack to align to 1 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 8 * (MAX_EXPERTS + 1) + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// TMA: a box of the tensor map at the given coordinates (innermost
// first) into shared memory, completing `bytes` on the barrier
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1) : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (the buffer must be
// 1 KB aligned): start address, leading and stride byte offsets
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}

#define ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 256] += A[64 x 16] B[16 x 256]: A K-major, B N-major (transpose
// bit set), both from shared-memory descriptors; d in the accumulator
// layout (row 16 * warp + lane / 4 (+ 8), columns 8 i + 2 (lane % 4) (+ 1))
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56),
        ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
      : "l"(da), "l"(db), "r"(1));
}
#undef ACC8

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__global__ void __launch_bounds__(THREADS, 1) grouped_matmul_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_a,  // lhs [M, H]: box [128 rows][64 k]
    const __grid_constant__ CUtensorMap map_b,  // rhs [E, H, F]: box [1][64 k][64 n]
    const int32_t* __restrict__ group_sizes,    // [E]
    __nv_bfloat16* __restrict__ out,            // [M, F]
    int M, int H, int F, int E)
{
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* ts = reinterpret_cast<int*>(smem + STAGES * STAGE_BYTES);  // [E + 1]
  int* rs = ts + E + 1;                                           // [E + 1]
  const int tid = threadIdx.x, warp = tid / 32;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival, plus the bytes
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  build_table<BM>(group_sizes, E, ts, rs);  // its barriers publish the mbarriers too
  const TileInfo t = locate<BM, BN>(ts, rs, E, M, (F + BN - 1) / BN, blockIdx.x);
  if (t.expert < 0) {  // uniform exit, after the zeros of rows past the groups
    zero_rows<BN>(out, t, F, tid, THREADS);
    return;
  }
  const int nk = (H + BK - 1) / BK;
  auto stage_a = [&](int s) { return smem + s * STAGE_BYTES; };
  auto stage_b = [&](int s) { return smem + s * STAGE_BYTES + A_BYTES; };

  if (warp < 4) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      // B boxes wholly past F are not loaded: their columns are never stored
      const int boxes = min(BN / B_BOX, (F - t.col0 + B_BOX - 1) / B_BOX);
      const uint32_t bytes = A_BYTES + boxes * B_BOX_BYTES;
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(&empty[s], ((kb / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], bytes);
        tma_load_2d(stage_a(s), &map_a, &full[s], kb * BK, t.row0);
        for (int c = 0; c < boxes; ++c)
          tma_load_3d(stage_b(s) + c * B_BOX_BYTES, &map_b, &full[s], t.col0 + c * B_BOX,
                      kb * BK, t.expert);
      }
    }
  } else {
    // consumer warpgroups: 64 rows each, all 256 columns
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4 - 1;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    fence_acc(d);
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % STAGES;
      mbar_wait(&full[s], (kb / STAGES) & 1);
      // A: 64 rows of 128 bytes from row 64 * wg, 8-row groups 1 KB
      // apart; a k16 step is 32 bytes along the row. B: [64 k][64 n]
      // boxes 8 KB apart along n, 8-row groups 1 KB apart along k; a k16
      // step is 16 rows, 2 KB.
      const uint64_t da = smem_desc(stage_a(s) + wg * 64 * 128, 16, 1024);
      const uint64_t db = smem_desc(stage_b(s), B_BOX_BYTES, 1024);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16(d, da + (kk * 32 >> 4), db + (kk * 2048 >> 4));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous stage's products are done: release its buffers
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kb > 0 && tid % 128 == 0) mbar_arrive(&empty[(kb - 1) % STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);

    // epilogue: bf16 pairs from the accumulators into a padded tile in
    // the ring (once both warpgroups are done reading it), then the
    // warpgroup's valid rows and columns out in 16-byte stores
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][EPI_ROW]
    const int lane = tid % 32, gid = lane >> 2, tig = lane & 3;
    const int r_a = wg * 64 + (warp % 4) * 16 + gid;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(tile + (r_a + 8 * h) * EPI_ROW + i * 8 + 2 * tig) =
            __floats2bfloat162_rn(d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
    asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
    for (int c = tid % 128; c < 64 * (BN / 8); c += 128) {
      const int r = wg * 64 + c / (BN / 8), col = t.col0 + (c % (BN / 8)) * 8;
      if (r < t.rows && col < F)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(t.row0 + r) * F + col) =
            *reinterpret_cast<const uint4*>(tile + r * EPI_ROW + (c % (BN / 8)) * 8);
    }
  }
}

// cuTensorMapEncodeTiled from libcuda, found at run time so that this
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map with a 128-byte swizzle; out-of-bounds elements of a
// box read as zero
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// lhs and rhs 16-byte aligned
extern "C" int grouped_matmul_bf16(
    const void* lhs, const void* rhs, const void* group_sizes, void* out,
    int M, int H, int F, int E, void* stream)
{
  if (M <= 0) return 0;
  if (H % 8 || F % 8 || E <= 0 || E > MAX_EXPERTS) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;  // once per process (host side)
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        grouped_matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  CUtensorMap map_a, map_b;
  const cuuint64_t a_dims[2] = {cuuint64_t(H), cuuint64_t(M)};
  const cuuint64_t a_strides[1] = {cuuint64_t(H) * 2};
  const cuuint32_t a_box[2] = {BK, BM};
  const cuuint64_t b_dims[3] = {cuuint64_t(F), cuuint64_t(H), cuuint64_t(E)};
  const cuuint64_t b_strides[2] = {cuuint64_t(F) * 2, cuuint64_t(H) * F * 2};
  const cuuint32_t b_box[3] = {B_BOX, BK, 1};
  if (!encode(&map_a, lhs, 2, a_dims, a_strides, a_box) ||
      !encode(&map_b, rhs, 3, b_dims, b_strides, b_box))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = ((M + BM - 1) / BM + E) * ((F + BN - 1) / BN);  // the static tile bound
  grouped_matmul_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<const int32_t*>(group_sizes), static_cast<__nv_bfloat16*>(out),
      M, H, F, E);
  return static_cast<int>(cudaGetLastError());
}
