// Space-time memory read for Hopper (sm_90a), CUDA C++ with plain C entries.
//
// Replaces otvm_tpu/kernels/memory_attn.py::memory_read_pallas (the Pallas
// TPU kernel, body _flash_kernel).  Computes, per batch element b,
//     out[q, :] = softmax_k( mask(Q[q] . K[k] / sqrt(Ck)) ) . V[k, :]
// over the bank flattened to T*HW memory positions, with an online softmax
// (running max, running sum, rescaled fp32 accumulator), so the [HW, T*HW]
// score matrix never reaches device memory.  Masked slots score -1e30 and p
// is not zeroed, as in memory_read_xla: with at least one valid slot this is
// the Pallas result; with none it is the uniform average (Pallas gives NaN).
// Positions past T*HW score -inf.  As in the Pallas kernel, the
// unnormalised p is rounded to the value dtype before the PV product (in
// fp32: not rounded), and the output takes q's dtype.  KV tiles that lie
// wholly in masked slots are skipped when at least one slot is valid
// (their p is exactly 0 then).
//
// What bounds it on an H100 (dense: 989 TFLOP/s bf16, 495 TF32, 67 fp32 on
// the CUDA cores; 3.35 TB/s): at 512p steady state (HW = 1024, 5 valid
// slots of T = 6, Ck = 128, Cv = 512) the read is 2 * 1024 * 5120 * (128 +
// 512) = 6.7 GFLOP against ~7.8 MB of bytes in bf16 (2.3 us) or ~15.7 MB in
// fp32 (4.7 us); at 1088x1920 (HW = 8160, 2 valid slots) 170 GFLOP.  The
// tensor cores bound it: bf16 6.8 us and 0.17 ms; fp32 as 3xTF32 (three
// TF32 products per product) 40.7 us and 1.03 ms (on the CUDA cores it
// would be 0.100 and 2.54 ms).  So both kernels run both products on them:
//
//   * memory_read_tc (bf16): one block per 128 query rows x CVT value
//     columns (CVT = 256, or 128 when Cv is not a multiple of 256) x one
//     share of the live K/V tiles.  Warpgroups 0-1 are consumers, 64 query
//     rows each; warpgroup 2 is the producer and hands its registers to
//     the consumers (setmaxnreg: 232 each, for a 64 x 256 fp32 accumulator
//     plus S and P).  One producer thread brings Q once and K/V tiles of 64
//     positions through a STAGES-deep ring of shared-memory stages by TMA
//     (128-byte swizzle; 64-byte for Ck = 32), with full/empty mbarriers;
//     TMA zero-fills rows past HW or T*HW.  Each consumer runs S = Q K^T as
//     wgmma m64n64k16 (A and B from shared memory, K-major), masks per
//     position, keeps the online softmax in registers, rounds p to bf16 in
//     the accumulator layout (which is the A-operand layout of the next
//     product), and runs O += P V as wgmma m64n128k16 with A from registers
//     and V MN-major (transposed B).  S is computed again for each CVT
//     slice: +20% operations at Cv = 512.
//   * Overlap: a consumer issues S_j together with P_(j-1) V_(j-1) and
//     computes the softmax of S_j while the tensor cores run; the two
//     consumers take turns on the tensor cores (named barriers), so one's
//     softmax overlaps the other's products.
//   * The grid alone fills the card at 1088x1920 (128 blocks); at 512p it
//     makes 16 blocks, so the wrapper splits the live K/V tiles across
//     `splits` <= 8 blocks per output tile, and the blocks merge their
//     partial results (unnormalised fp32 O and (m, l)) in the same launch,
//     each a share of the tile's rows (see split_epilogue).  Where the
//     card holds one cluster a tile in one wave, the tile's splits are a
//     thread-block cluster: each leaves its partial in its own shared
//     memory, where Q and the ring were, and they merge through
//     distributed shared memory.  Elsewhere (512p: the card holds only 15
//     clusters of 8 blocks, and 16 tiles need 16) the grid is launched
//     without clusters and cooperatively, all its blocks on the card at
//     once (whatever other streams' kernels hold), and the splits
//     merge through a workspace in L2 after a barrier of the tile's blocks
//     in device memory.  The Pallas kernel carries the partials in VMEM
//     over its sequential K/V grid axis instead (_flash_kernel's scratch
//     and _finish, otvm_tpu/kernels/memory_attn.py:111-126).  With splits
//     = 1 the block writes out.
//   * memory_read_f32tc (fp32): 3xTF32 on wgmma, split and merged as
//     above, over 64 query rows a block.  Each fp32 operand x is hi = x as
//     it stands (wgmma reads a tf32 operand's 19 high bits: trunc(x)) and
//     lo = x - trunc(x) (exact in fp32, read as trunc(lo)), and a b is
//     a_hi b_lo + a_lo b_hi + a_hi b_hi, small terms first, summed in
//     fp32: x to 2^-20 |x|, fp32's accuracy in practice, where plain TF32
//     is ~1000x worse.  Each tile's P V goes to a fresh accumulator that
//     the FPU adds to O: the tensor cores truncate as they accumulate, and
//     over a whole bank that bias reaches 1e-4.  tf32 wgmma takes B only
//     K-major from shared memory, and V is MN-major, so P V runs
//     transposed, O^T = V^T P^T: A = V^T from registers (loaded from V's
//     tile as TMA left it), B = P^T, which the softmax writes K-major.
//     Each K, V and p value is split once, by one thread:
//       - warpgroup 3: one thread brings Q once and K/V tiles of 32
//         positions (48 KB at CVT = 256) by TMA into a 3-stage ring; its
//         other three warps write each K tile's lo (K_lo) beside it;
//       - warpgroup 2 (S): Q's 64 rows as A fragments, hi and lo, in its
//         registers; S = Q K^T as wgmma m64n32k8, B = K and K_lo; the
//         online softmax; p and p - trunc(p) into a P slot (two slots);
//       - warpgroups 0 and 1 (P V): half the value columns each, as
//         m-tiles of 64: A = V^T's fragment, split in registers, B = the P
//         slot, wgmma m64n64k8.
//     S is still computed for each CVT slice (Q's 128 rows in hi and lo
//     would not fit beside O).  On an H100 80GB HBM3 at 700 W (device time,
//     L2 flushed): 1088x1920, 2 valid slots of 3, 2.36-2.43 ms against the
//     1.033 bound (4.014 on mma.sync m16n8k8, the design before); 5 valid
//     of 6, 5.86-5.96; 512p 0.109-0.112 against 0.0407; training (B 4, HW
//     400) T 1 0.032-0.033, T 2 0.046-0.049 against 0.0050 and 0.0099.
//     S alone and P V alone each take ~1.37 ms at 1088x1920: the two share
//     the tensor cores, and S's m64n32 products run well below their peak
//     rate.
// Times on the card beside these bounds: PERF.md (chip_smoke.py phase 3).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_T = 256;      // bank slots
constexpr int MAX_SPLITS = 8;   // blocks of an output tile; of a cluster, the portable size

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (TMA ring, wgmma)
// ---------------------------------------------------------------------------

constexpr int BQ = 128;                   // query rows per block: 64 per consumer warpgroup
constexpr int BK = 64;                    // memory positions per K/V tile
constexpr int STAGES = 3;                 // K/V ring depth
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
// setmaxnreg: 128 x 40 + 256 x 232 = 64512 of the SM's 65536 registers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// A split bf16 block's partial result, in its shared memory from the
// aligned start of Q (Q and the ring are free by then): O [BQ rows x CVT]
// fp32, rows STRIDE floats apart, then (m, l) per row.  PAD 8 keeps the
// consumers' stores in wgmma's fragment layout (8-byte stores, half a warp
// on four rows) free of bank conflicts.
template <int CVT, int PAD>
struct MergeTile {
    static constexpr int STRIDE = CVT + PAD;
    static constexpr int ML_OFF = BQ * STRIDE * 4;
    static constexpr int BYTES = ML_OFF + BQ * 8;
};

template <int CK, int CVT>
struct Layout {
    static constexpr int CKB = CK < 64 ? CK : 64;   // key columns per TMA box (<= 128 bytes)
    static constexpr int SWZ = CKB * 2;             // swizzle span in bytes: 128, or 64 at Ck = 32
    static constexpr int KBOX = BK * CKB * 2;       // bytes of one 64-row key/query box
    static constexpr int Q_HALF = 64 * CK * 2;      // one consumer's 64 query rows
    static constexpr int Q_BYTES = 2 * Q_HALF;
    static constexpr int K_BYTES = BK * CK * 2;
    static constexpr int V_BYTES = BK * CVT * 2;    // CVT / 64 boxes of 64 x 64
    static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
    using Merge = MergeTile<CVT, 8>;
    // + alignment slack; at Ck = 32 and CVT = 256 the merge tile is the larger
    static constexpr int SMEM = cmax(Q_BYTES + STAGES * STAGE_BYTES, Merge::BYTES) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the barrier's phase differs from `parity`.  A wait of more
// than 2^34 cycles (~9 s) is a broken pipeline: trap, so the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    long long start = 0;
    for (;;) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (start == 0) start = clock64();
        else if (clock64() - start > (1ll << 34)) __trap();
    }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// wgmma shared-memory descriptors (start address, LBO, SBO in 16-byte units;
// layout type 1 = 128-byte swizzle, 2 = 64-byte swizzle).
// K-major, rows of SWZ bytes, 8-row groups SWZ * 8 bytes apart; LBO unused.
template <int SWZ>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
    constexpr uint64_t layout = SWZ == 128 ? 1 : 2;
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
           ((uint64_t)((SWZ * 8) >> 4) << 32) | (layout << 62);
}
// MN-major (V: value columns contiguous), 128-byte swizzle: 64-column atoms
// 8192 bytes apart (LBO, one 64 x 64 box), 8-row groups 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(8192 >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching a register that an in-flight wgmma reads
// or writes: every use after the wait depends on this.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

#define F8(d, i)                                                                          \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
        "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]; A from registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a,
                                                    uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// The K/V tiles a block reads, as ranges [x, y) of tile indices (tile i
// covers positions [TILE i, TILE i + TILE)): with a valid slot, the tiles
// that touch one; with none, all of them.  Built once per block by one
// thread.
struct TileRanges {
    int2 r[MAX_T + 1];   // + 1: TileCursor::next may read one past the last
    int n;               // ranges
    int live;            // tiles in all ranges
};

template <int TILE = BK>
__device__ void build_ranges(TileRanges& tr, const uint8_t* mask_s, int hw, int t,
                             bool any_valid) {
    const int kv_len = t * hw;
    int n = 0;
    if (!any_valid) {
        tr.r[n++] = make_int2(0, (kv_len + TILE - 1) / TILE);
    } else {
        for (int s = 0; s < t; ++s) {
            if (!mask_s[s]) continue;
            const int x = s * hw / TILE, y = ((s + 1) * hw - 1) / TILE + 1;
            if (n > 0 && x <= tr.r[n - 1].y) tr.r[n - 1].y = max(tr.r[n - 1].y, y);
            else tr.r[n++] = make_int2(x, y);
        }
    }
    int live = 0;
    for (int i = 0; i < n; ++i) live += tr.r[i].y - tr.r[i].x;
    tr.n = n;
    tr.live = live;
}

// Walks the live tiles in order, from a given rank.
struct TileCursor {
    const int2* r;
    int i, tile;
    __device__ __forceinline__ TileCursor(const TileRanges& tr, int rank) : r(tr.r), i(0) {
        while (rank >= r[i].y - r[i].x) rank -= r[i].y - r[i].x, ++i;
        tile = r[i].x + rank;
    }
    __device__ __forceinline__ void next() {
        if (++tile == r[i].y) tile = r[++i].x;
    }
};

__device__ __forceinline__ void named_bar_sync(int id) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
    uint2 packed;
    packed.x = pack_bf16(x.x, x.y);
    packed.y = pack_bf16(x.z, x.w);
    *reinterpret_cast<uint2*>(p) = packed;
}
__device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
}

// A cluster launch is one cluster per (query tile, value tile, batch row):
// cluster dims (1, 1, splits) over grid z = b * splits + split, so a
// block's rank in its cluster is its split.  A launch where that fails
// traps rather than merge the wrong blocks.  Checked in split_epilogue,
// before the merge.
__device__ __forceinline__ void check_cluster(int split, int splits) {
    const cg::cluster_group cluster = cg::this_cluster();
    if (cluster.block_rank() != (unsigned)split || cluster.num_blocks() != (unsigned)splits)
        __trap();
}

// The splits' partial results as a cluster merge reads them: block s's
// shared memory (O rows STRIDE floats apart, and (m, l) per row), its own
// directly and its peers' through distributed shared
// memory, which moves a fraction of what local shared memory or L2 does.
template <int STRIDE>
struct ClusterPartials {
    float* o_s;
    float2* ml_s;
    int rank;
    template <typename P>
    __device__ __forceinline__ P* at(P* p, int s) const {
        return s == rank ? p : cg::this_cluster().map_shared_rank(p, s);
    }
    __device__ __forceinline__ float2 ml(int s, int r) const { return *at(ml_s + r, s); }
    __device__ __forceinline__ float4 o(int s, int r, int c) const {
        return *reinterpret_cast<const float4*>(at(o_s + r * STRIDE + c, s));
    }
};

// The splits' partial results as an L2 merge reads them: split s's O rows
// of the tile at part_o + s * split_o (rows cv floats apart), its (m, l)
// at part_ml + s * split_ml; loaded with ld.global.cg (L2: other blocks
// wrote them).
struct L2Partials {
    const float* part_o;
    const float2* part_ml;
    long split_o, split_ml;
    int cv;
    __device__ __forceinline__ float2 ml(int s, int r) const {
        return __ldcg(part_ml + s * split_ml + r);
    }
    __device__ __forceinline__ float4 o(int s, int r, int c) const {
        return __ldcg(reinterpret_cast<const float4*>(part_o + s * split_o + (long)r * cv + c));
    }
};

// The merge of a tile's `splits` partials, run by the 256 consumer threads
// of each block (threads 0-255, named barrier 3) once every split's
// partial is in place.  Block `split` merges the tile's rows [split ROWS /
// splits, (split + 1) ROWS / splits) below `rows` (the tile's rows inside
// HW; ROWS is the kernel's query tile):
//     out[r, :] = sum_s w_s O_s[r, :] / sum_s w_s l_s,  w_s = 2^(m_s - M),
//     M = max_s m_s,
// each sum taken over s = 0 .. splits - 1 in order (combine_plain in
// memory_attn.py is its plain version).  First one thread a row forms the
// row's weights and 1 / sum_s w_s l_s into `w_row`; then every thread
// takes 16 bytes of a row at a time, two chunks at once, with the loads of
// all splits issued before the arithmetic.  A split with no live tile
// holds m = -inf, l = 0, O = 0, and weighs 0.  `out` points at the tile's
// first row and value column.
template <int CVT, int ROWS, typename Partials, typename T>
__device__ __forceinline__ void merge_splits(const Partials& in, int split, int splits, int rows,
                                             T* out, int cv, int tid) {
    __shared__ float w_row[ROWS / 2][MAX_SPLITS + 1];   // w_s, then 1 / sum_s w_s l_s
    const int r_lo = split * ROWS / splits, r_hi = min((split + 1) * ROWS / splits, rows);
    if (tid < r_hi - r_lo) {
        float2 ml[MAX_SPLITS];
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s)
            if (s < splits) ml[s] = in.ml(s, r_lo + tid);
        float m_max = -INFINITY;
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s)
            if (s < splits) m_max = fmaxf(m_max, ml[s].x);
        float den = 0.f;
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s)
            if (s < splits) {
                const float w = exp2f(ml[s].x - m_max);
                w_row[tid][s] = w;
                den += w * ml[s].y;
            }
        w_row[tid][MAX_SPLITS] = 1.f / den;
    }
    named_bar_sync(3);
    constexpr int C4 = CVT / 4;   // 16-byte chunks of a row
    constexpr int U = 2;          // chunks a thread has in flight
    const int end = (r_hi - r_lo) * C4;
    for (int base = tid; base < end; base += U * CONSUMERS) {
        float4 a[U][MAX_SPLITS];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int idx = min(base + u * CONSUMERS, end - 1);
#pragma unroll
            for (int s = 0; s < MAX_SPLITS; ++s)
                if (s < splits) a[u][s] = in.o(s, r_lo + idx / C4, idx % C4 * 4);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int idx = base + u * CONSUMERS;
            if (idx >= end) break;
            const float* w = w_row[idx / C4];
            float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int s = 0; s < MAX_SPLITS; ++s)
                if (s < splits) {
                    sum.x += w[s] * a[u][s].x;
                    sum.y += w[s] * a[u][s].y;
                    sum.z += w[s] * a[u][s].z;
                    sum.w += w[s] * a[u][s].w;
                }
            const float inv = w[MAX_SPLITS];
            store4(out + (long)(r_lo + idx / C4) * cv + idx % C4 * 4,
                   make_float4(sum.x * inv, sum.y * inv, sum.z * inv, sum.w * inv));
        }
    }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// A sense-reversing barrier of a tile's `splits` blocks in device memory,
// run by one thread of each once its block's partial is stored: bar[0]
// counts arrivals, bar[1] counts completed barriers.  Each reads the count
// of completed barriers, arrives after a release fence, and waits for the
// count to move; the last to arrive sets bar[0] back to 0 (for the next
// launch) before it moves it.  Only a launch whose whole grid is on the
// card at once may wait so: launch_read launches such a grid cooperatively,
// so the runtime makes every block resident before any runs, or refuses
// the launch (another stream's kernel may hold SMs; launch_geometry also
// checks the grid against the empty card); a wait of more than 2^32 cycles
// (~2 s) traps instead of hanging the card.
__device__ __forceinline__ void tile_barrier(unsigned* bar, int splits) {
    const unsigned done = ld_acquire(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == (unsigned)splits - 1) {
        atomicExch(bar, 0u);
        __threadfence();
        atomicAdd(bar + 1, 1u);
    } else {
        const long long start = clock64();
        while (ld_acquire(bar + 1) == done) {
            __nanosleep(32);
            if (clock64() - start > (1ll << 32)) __trap();
        }
    }
    __threadfence();
}

// %ctaid.<axis>, read anew where it is used: the asm is volatile, so the
// compiler cannot keep an index computed before the main loop live in a
// register across it (the consumers use all of theirs there).
template <int AXIS>
__device__ __forceinline__ int block_index() {
    int v;
    if (AXIS == 0) asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(v));
    else if (AXIS == 1) asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(v));
    else asm volatile("mov.u32 %0, %%ctaid.z;\n" : "=r"(v));
    return v;
}

// The L2 workspace of a split launch without clusters, from `part`: O
// [splits, B, HW, Cv] fp32, then (m, l) [splits, B, HW]; split s's share
// starts s split_o floats into O and s split_ml pairs into (m, l).
struct Workspace {
    long split_ml, split_o;
    float* o;
    float2* ml;
    __device__ __forceinline__ Workspace(float* part, int hw, int cv, int splits)
        : split_ml((long)(gridDim.z / splits) * hw), split_o(split_ml * cv), o(part),
          ml(reinterpret_cast<float2*>(part + splits * split_o)) {}
};

// The epilogue of a split block (splits > 1), run by the 256 threads that
// hold O (threads 0-255) once they are past their last tile: `store(o,
// stride, ml, rows)` puts the block's O (fp32, unnormalised, rows `stride`
// floats apart) at o and, where those threads hold it, its (m, l) at ml,
// the rows below `rows`; then the tile's splits merge.  ROWS is the
// kernel's query tile.  In a cluster launch (blocks == splits) the partial
// goes to the block's own shared memory, O at o_s and (m, l) at ml_s (Q
// and the ring are free: every consumer is past its last tile, so every
// TMA load has landed), and the cluster merges through distributed shared
// memory between two cluster barriers, which the block's other warpgroups
// meet too.  Otherwise (blocks == 1) it goes to the Workspace at `part`,
// every thread that stores a share of it meets the others at named
// barrier STORED (STORED_COUNT threads), and the tile's blocks meet at
// tile_barrier on `bars` (two counters per tile) before they merge from
// L2.  Block indices are read anew here (block_index).
template <int CVT, int ROWS, int STRIDE, int STORED, int STORED_COUNT, typename T,
          typename Store>
__device__ __forceinline__ void split_epilogue(float* o_s, float2* ml_s, Store store, int hw,
                                               int cv, int splits, int blocks, float* part,
                                               unsigned* bars, T* out, int tid) {
    const int x = block_index<0>(), y = block_index<1>(), z = block_index<2>();
    const int b = z / splits, split = z % splits, q0 = x * ROWS;
    const long tile = (long)b * hw + q0;   // the tile's first row of B * HW
    const int rows = min(ROWS, hw - q0);
    T* out_t = out + tile * cv + y * CVT;
    if (blocks > 1) {
        check_cluster(split, splits);
        named_bar_sync(3);   // every consumer past its last tile
        store(o_s, STRIDE, ml_s, rows);
        cg::this_cluster().sync();
        merge_splits<CVT, ROWS>(ClusterPartials<STRIDE>{o_s, ml_s, split}, split, splits, rows,
                                out_t, cv, tid);
        cg::this_cluster().sync();   // no block's shared memory goes while a peer reads it
        return;
    }
    const Workspace ws(part, hw, cv, splits);
    const long at = tile * cv + y * CVT;
    store(ws.o + split * ws.split_o + at, cv, ws.ml + split * ws.split_ml + tile, rows);
    // every share of the partial stored
    asm volatile("bar.sync %0, %1;\n" ::"n"(STORED), "n"(STORED_COUNT) : "memory");
    if (tid == 0) tile_barrier(bars + 2 * ((long)(b * gridDim.y + y) * gridDim.x + x), splits);
    named_bar_sync(3);
    merge_splits<CVT, ROWS>(L2Partials{ws.o + at, ws.ml + tile, ws.split_o, ws.split_ml, cv},
                            split, splits, rows, out_t, cv, tid);
}

// Grid: (HW / 128 query tiles, Cv / CVT value tiles, B * splits).  Block
// split s of batch row b reads live tiles [s L / splits, (s + 1) L / splits)
// of the L live tiles.  splits == 1: writes out.  splits > 1: each block,
// past its last tile, hands its unnormalised O and its (m, l) (running
// max in log2 units, sum of p) to split_epilogue, which merges the tile's
// splits, in its cluster (blocks == splits) or through `part` and `bars`
// (blocks == 1), and writes out.
//
// Each consumer warpgroup pipelines its tiles: in the turn of tile j it
// issues S_j = Q K_j^T and O += P_(j-1) V_(j-1) together, then computes the
// softmax of S_j while the tensor cores run.  The two warpgroups take turns
// on the tensor cores (named barriers 1 and 2), so one's softmax overlaps
// the other's products.
template <int CK, int CVT>
__global__ void __launch_bounds__(THREADS, 1)
memory_read_tc(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, const uint8_t* __restrict__ slot_mask,
               __nv_bfloat16* __restrict__ out, int hw, int t, int cv, int splits, int blocks,
               float* __restrict__ part, unsigned* __restrict__ bars, float scale_log2) {
    using L = Layout<CK, CVT>;
    extern __shared__ uint8_t smem_raw[];
    __shared__ uint64_t full_bar[STAGES];
    __shared__ uint64_t empty_bar[STAGES];
    __shared__ uint64_t q_bar;
    __shared__ uint8_t mask_s[MAX_T + 1];
    __shared__ int any_valid_s;
    __shared__ TileRanges ranges;

    // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles to it
    const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t stage0 = q_s + L::Q_BYTES;

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * BQ;
    const int cv0 = blockIdx.y * CVT;
    const int b = blockIdx.z / splits;
    const int split = blockIdx.z % splits;
    const int kv_len = t * hw;

    if (tid == 0) {
        any_valid_s = 0;
        for (int i = 0; i < STAGES; ++i) {
            mbar_init(smem_u32(&full_bar[i]), 1);
            mbar_init(smem_u32(&empty_bar[i]), CONSUMERS);
        }
        mbar_init(smem_u32(&q_bar), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    for (int i = tid; i < t; i += THREADS) {
        const uint8_t m = slot_mask[(long)b * t + i];
        mask_s[i] = m;
        if (m) any_valid_s = 1;
    }
    __syncthreads();
    if (tid == 0) build_ranges(ranges, mask_s, hw, t, any_valid_s != 0);
    __syncthreads();
    // warp-uniform by construction; the shuffle lets the compiler see it
    // (a wgmma under a branch it cannot prove uniform is serialized)
    const int live = __shfl_sync(0xffffffffu, ranges.live, 0);
    const int lo = (int)((long)split * live / splits);
    const int n_mine = (int)((long)(split + 1) * live / splits) - lo;
    const int warpgroup = __shfl_sync(0xffffffffu, tid / 128, 0);

    if (warpgroup == CONSUMERS / 128) {
        // ---- producer warpgroup: gives registers away; one thread issues every TMA load ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        if (tid == CONSUMERS && n_mine > 0) {
            const uint32_t qb = smem_u32(&q_bar);
            mbar_expect_tx(qb, L::Q_BYTES);
            for (int h = 0; h < 2; ++h)
                for (int cb = 0; cb < CK / L::CKB; ++cb)
                    tma_load_3d(q_s + h * L::Q_HALF + cb * L::KBOX, &q_map, qb, cb * L::CKB,
                                q0 + 64 * h, b);
            TileCursor cur(ranges, lo);
            int stage = 0;
            uint32_t phase = 0;
            for (int j = 0; j < n_mine; ++j, cur.next()) {
                mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
                const uint32_t fb = smem_u32(&full_bar[stage]);
                mbar_expect_tx(fb, L::STAGE_BYTES);
                const uint32_t ks = stage0 + stage * L::STAGE_BYTES;
                const uint32_t vs = ks + L::K_BYTES;
                for (int cb = 0; cb < CK / L::CKB; ++cb)
                    tma_load_3d(ks + cb * L::KBOX, &k_map, fb, cb * L::CKB, cur.tile * BK, b);
                for (int c = 0; c < CVT / 64; ++c)
                    tma_load_3d(vs + c * 8192, &v_map, fb, cv0 + 64 * c, cur.tile * BK, b);
                if (++stage == STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
        if (blocks > 1) {   // the cluster merge's two barriers count every thread
            cg::this_cluster().sync();
            cg::this_cluster().sync();
        }
    } else {
        // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
        const int wg = warpgroup;
        const int warp = (tid % 128) / 32, lane = tid % 32;
        const int rq = warp * 16 + lane / 4;   // this thread's rows (of the 64): rq, rq + 8
        const int cq = (lane % 4) * 2;         // its first column in each 8-column chunk
        const uint32_t q_wg = q_s + wg * L::Q_HALF;

        // accumulator layout of wgmma m64nN: o[4 n + 2 i + j] is row rq + 8 i,
        // column 8 n + cq + j; here split in 128-column halves o[64 h + ...]
        float o[CVT / 2];
#pragma unroll
        for (int i = 0; i < CVT / 2; ++i) o[i] = 0.f;
        float m_run[2] = {-INFINITY, -INFINITY};
        float l_run[2] = {0.f, 0.f};   // this thread's share of the row sums
        float s[32];                   // S_j, then its p (fp32)
        uint32_t a[16];                // P_(j-1) in bf16: chunk kk of 16 positions is a[4 kk ..]

        // turns on the tensor cores: warpgroup 0 first, then 1, then 0, ...
        // (each sync needs the other's arrive, or warpgroup 0's own first one)
        const int my_turn = 1 + wg, their_turn = 2 - wg;
        if (wg == 0 && n_mine > 0) named_bar_arrive(my_turn);

        auto issue_s = [&](uint32_t ks) {
#pragma unroll
            for (int kk = 0; kk < CK / 16; ++kk) {
                // 16 key columns = 32 bytes; boxes of CKB columns
                const uint32_t off = (kk * 16 / L::CKB) * L::KBOX + (kk * 16 % L::CKB) * 2;
                wgmma_m64n64k16_ss(s, desc_k_major<L::SWZ>(q_wg + off),
                                   desc_k_major<L::SWZ>(ks + off), 1);
            }
            wgmma_commit();
        };
        auto issue_pv = [&](uint32_t vs) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int h = 0; h < CVT / 128; ++h)
                    wgmma_m64n128k16_rs(o + 64 * h, a + 4 * kk,
                                        desc_mn_major(vs + h * 2 * 8192 + kk * 2048));
            wgmma_commit();
        };
        // mask S_j, update m and l, p = 2^(S - m) into s; returns alpha
        auto softmax = [&](int tile, float* alpha) {
            const int p0 = tile * BK;
            const int slot_a = p0 / hw;
            const int bnd = (slot_a + 1) * hw - p0;   // first column of the next slot
            const bool two_slots = (min(p0 + BK, kv_len) - 1) / hw <= slot_a + 1;
            float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
            for (int n = 0; n < 8; ++n)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int col = 8 * n + cq + j;
                    const bool in_range = p0 + col < kv_len;
                    const int slot =
                        col < bnd ? slot_a : (two_slots ? slot_a + 1 : (p0 + col) / hw);
                    const bool valid = in_range && mask_s[slot] != 0;
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        float& x = s[4 * n + 2 * i + j];
                        x = !in_range ? -INFINITY : (valid ? x * scale_log2 : -1e30f);
                        mx[i] = fmaxf(mx[i], x);
                    }
                }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
                alpha[i] = exp2f(m_run[i] - mx[i]);
                m_run[i] = mx[i];
                l_run[i] *= alpha[i];
            }
#pragma unroll
            for (int n = 0; n < 8; ++n)
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        float& x = s[4 * n + 2 * i + j];
                        x = exp2f(x - m_run[i]);
                        l_run[i] += x;
                    }
        };
        // P_j to bf16 (the accumulator layout is the A-operand layout),
        // O rescaled to the new max
        auto to_a_and_rescale = [&](const float* alpha) {
#pragma unroll
            for (int n = 0; n < 8; ++n)
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    a[4 * (n / 2) + 2 * (n % 2) + i] =
                        pack_bf16(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]);
#pragma unroll
            for (int n = 0; n < CVT / 8; ++n) {
                o[4 * n + 0] *= alpha[0];
                o[4 * n + 1] *= alpha[0];
                o[4 * n + 2] *= alpha[1];
                o[4 * n + 3] *= alpha[1];
            }
        };

        auto wait_pv_and_release = [&](int st) {
            wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < CVT / 2; ++i) reg_fence(o[i]);
#pragma unroll
            for (int i = 0; i < 16; ++i) reg_fence(a[i]);
            mbar_arrive(smem_u32(&empty_bar[st]));
        };

        // Turn 0 issues S_0; turn j in [1, n_mine) issues S_j and
        // P_(j-1) V_(j-1); turn n_mine issues the last P V.  No wgmma sits
        // under a branch: n_mine is warp-uniform, and the loop body is
        // straight.
        if (n_mine > 0) {
            mbar_wait(smem_u32(&q_bar), 0);
            TileCursor cur(ranges, lo);
            float alpha[2];
            mbar_wait(smem_u32(&full_bar[0]), 0);
#pragma unroll
            for (int i = 0; i < 32; ++i) s[i] = 0.f;   // before the fence: wgmma reads it
            named_bar_sync(my_turn);
            wgmma_fence();
            issue_s(stage0);
            named_bar_arrive(their_turn);
            wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < 32; ++i) reg_fence(s[i]);
            softmax(cur.tile, alpha);
            to_a_and_rescale(alpha);
            cur.next();
            int prev_stage = 0, stage = 1;
            uint32_t phase = 0;
            if (stage == STAGES) stage = 0, phase = 1;
            for (int j = 1; j < n_mine; ++j) {
                mbar_wait(smem_u32(&full_bar[stage]), phase);
#pragma unroll
                for (int i = 0; i < 32; ++i) s[i] = 0.f;
                named_bar_sync(my_turn);
                wgmma_fence();
                issue_s(stage0 + stage * L::STAGE_BYTES);
                issue_pv(stage0 + prev_stage * L::STAGE_BYTES + L::K_BYTES);
                named_bar_arrive(their_turn);
                wgmma_wait<1>();   // S_j is done; P_(j-1) V_(j-1) may still run
#pragma unroll
                for (int i = 0; i < 32; ++i) reg_fence(s[i]);
                softmax(cur.tile, alpha);
                wait_pv_and_release(prev_stage);
                to_a_and_rescale(alpha);
                cur.next();
                prev_stage = stage;
                if (++stage == STAGES) stage = 0, phase ^= 1;
            }
            named_bar_sync(my_turn);
            wgmma_fence();
            issue_pv(stage0 + prev_stage * L::STAGE_BYTES + L::K_BYTES);
            if (wg == 0) named_bar_arrive(their_turn);   // warpgroup 1 takes no further turn
            wait_pv_and_release(prev_stage);
        }

#pragma unroll
        for (int i = 0; i < 2; ++i) {
            l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
            l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
        }
        if (splits == 1) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int row = q0 + 64 * wg + rq + 8 * i;
                if (row >= hw) continue;
                const float inv = 1.f / l_run[i];
                __nv_bfloat16* ob = out + ((long)b * hw + row) * cv + cv0 + cq;
#pragma unroll
                for (int n = 0; n < CVT / 8; ++n)
                    *reinterpret_cast<uint32_t*>(ob + 8 * n) =
                        pack_bf16(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
            }
        } else {
            using M = typename L::Merge;
            uint8_t* tile_s = smem_raw + (q_s - smem_u32(smem_raw));
            split_epilogue<CVT, BQ, M::STRIDE, 3, CONSUMERS>(
                reinterpret_cast<float*>(tile_s), reinterpret_cast<float2*>(tile_s + M::ML_OFF),
                [&](float* to, int stride, float2* ml_to, int rows) {
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        const int row = 64 * wg + rq + 8 * i;
                        if (row >= rows) continue;
#pragma unroll
                        for (int n = 0; n < CVT / 8; ++n)
                            *reinterpret_cast<float2*>(to + row * stride + 8 * n + cq) =
                                make_float2(o[4 * n + 2 * i], o[4 * n + 2 * i + 1]);
                        if (lane % 4 == 0) ml_to[row] = make_float2(m_run[i], l_run[i]);
                    }
                },
                hw, cv, splits, blocks, part, bars, out, tid);
        }
    }
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 on wgmma, TMA ring
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64;                  // query rows per block
constexpr int F_BK = 32;                  // memory positions per K/V tile
constexpr int F_STAGES = 3;               // K/V ring depth
constexpr int F_PV = 256;                 // warpgroups 0-1: P V, half the value columns each
constexpr int F_S_WG = 2;                 // warpgroup 2: S and the softmax; 3: the producer
constexpr int F_THREADS = F_PV + 256;
// setmaxnreg: 128 x (144 + 144 + 200 + 24) = 65536, the SM's registers.
// The S warpgroup holds Q's A fragments, CK registers (hi and lo).
constexpr int F_PV_REGS = 144;
constexpr int F_S_REGS = 200;
constexpr int F_PRODUCER_REGS = 24;
// named barrier beside merge_splits's 3 (the P V warpgroups): those and the S warpgroup
constexpr int BAR_PV_S = 4;

// Every tile is a stack of TMA boxes 32 fp32 (128 bytes) wide, rows 128
// bytes apart; the 128-byte swizzle puts 16-byte chunk c of row r at chunk
// c ^ (r % 8), which is also wgmma's 128-byte swizzle.  From the aligned
// start of dynamic shared memory: Q (CK / 32 boxes of 64 rows), whose
// space then holds two K_lo slots (the low parts of a K tile, in the K
// tile's layout); the ring, each stage CK / 32 key boxes then CVT /
// 32 value boxes of F_BK rows; two P slots, each P_hi then P_lo, 64 query
// rows of 32 positions (one box).
template <int CK, int CVT>
struct F32Layout {
    static constexpr int Q_BOX = F_BQ * 128;
    static constexpr int Q_BYTES = CK / 32 * Q_BOX;
    static constexpr int KV_BOX = F_BK * 128;
    static constexpr int K_BYTES = CK / 32 * KV_BOX;
    static constexpr int STAGE_BYTES = K_BYTES + CVT / 32 * KV_BOX;
    static constexpr int STAGE0 = Q_BYTES;
    static constexpr int P_BYTES = F_BQ * 128;
    static constexpr int P0 = STAGE0 + F_STAGES * STAGE_BYTES;
    // a split block's O partial, [64 rows x CVT] fp32 from the aligned
    // start (where Q and the ring were); PAD 4 keeps the P V warpgroups'
    // 8-byte stores, a half warp on four rows, free of bank conflicts
    static constexpr int STRIDE = CVT + 4;
    // + alignment slack
    static constexpr int SMEM = cmax(P0 + 4 * P_BYTES, F_BQ * STRIDE * 4) + 1024;
    static_assert(2 * K_BYTES <= Q_BYTES, "two K_lo slots live where Q was");
};

// byte offset of 16-byte chunk `chunk` of row `row` in a swizzled box
__device__ __forceinline__ uint32_t swz128(int row, int chunk) {
    return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
    uint32_t x;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(x) : "r"(addr));
    return x;
}
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
    uint2 x;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(x.x), "=r"(x.y) : "r"(addr));
    return x;
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
    uint4 x;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w) : "r"(addr));
    return x;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t x) {
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 x) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 ::"r"(addr), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w) : "memory");
}
// Shared-memory writes of this thread, made visible to the async proxy
// (wgmma reads its shared-memory operands through it).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The 3xTF32 split.  wgmma reads a tf32 operand's 19 high bits and drops
// the 13 low ones (round toward zero), so an fp32 x as it stands is hi =
// trunc(x), and lo = x - trunc(x) is exact in fp32 and read as trunc(lo):
// x = hi + lo to 2^-20 |x|.  Both products are a_hi b_lo + a_lo b_hi +
// a_hi b_hi, summed in fp32 (memory_read_tf32_plain in memory_attn.py).
__device__ __forceinline__ uint32_t tf32_lo(uint32_t x) {
    return __float_as_uint(__uint_as_float(x) - __uint_as_float(x & 0xffffe000u));
}

#define F8(d, i)                                                                          \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
        "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x 32] (+)= A[64 x 8] B[8 x 32], tf32: A from registers (the
// m16n8k8 fragment of each warp's 16 rows), B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_m64n32(float* d, const uint32_t* a, uint64_t desc_b,
                                                  int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : F8(d, 0), F8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] B[8 x 64], as above
__device__ __forceinline__ void wgmma_tf32_m64n64(float* d, const uint32_t* a, uint64_t desc_b,
                                                  int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

#undef F8

// Grid: (HW / 64 query tiles, Cv / CVT value tiles, B * splits); split
// and merge as memory_read_tc's (splits, blocks, part, bars), with 64-row
// tiles.  Four warpgroups:
//   * 3, the producer: one thread brings Q once and the live K/V tiles of
//     the block's split through the F_STAGES-deep ring by TMA; its warps
//     1-3 write each K tile's K_lo (the K tile itself is K_hi) into one of
//     two slots where Q was, each K value split once.
//   * 2, S: holds the 64 query rows of Q as 3xTF32 A fragments in its
//     registers (hi and lo: CK of them).  Per tile it runs S = Q K^T as CK
//     / 8 k-steps of three wgmma m64n32k8 (small terms first), masks, keeps
//     the online softmax (m, l) per row, and writes p as P_hi (p as it
//     stands) and P_lo into a P slot with each row's rescale alpha =
//     2^(m_old - m_new), each p split once.
//   * 0 and 1, P V: warpgroup h owns value columns [h CVT / 2, (h + 1) CVT
//     / 2) as O^T = V^T P^T: per 64 value columns (an m-tile), A = V^T from
//     registers, loaded from the stage's V as it stands and split there,
//     each value by one thread once, and B = P^T, the P slot, K-major (its
//     rows are query rows, positions contiguous).  Each tile's product goes
//     to a fresh accumulator F, F_BK / 8 k-steps of three wgmma m64n64k8
//     deep, which the FPU adds to O as O = alpha O + F: the tensor cores
//     truncate as they accumulate, and summed over a whole bank into O
//     that bias reaches 1e-4.
// Positions are renumbered inside each k-step, alike in P and V: k-index
// tq of k-step kk is position 8 kk + 2 tq, k-index tq + 4 position 8 kk +
// 2 tq + 1, so that S's accumulator columns (8 n + 2 tq, + 1) store as they
// stand and a thread's V fragment of a k-step is two 8-byte loads (rows 2
// tq and 2 tq + 1); value columns are renumbered inside each warp's 16
// m-rows (m-row g is column 2 g, g + 8 is 2 g + 1), so that each of those
// loads holds both of a thread's columns.  Every shared-memory access of
// the main loop is free of bank conflicts.
template <int CK, int CVT>
__global__ void __launch_bounds__(F_THREADS, 1)
memory_read_f32tc(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, const uint8_t* __restrict__ slot_mask,
                  float* __restrict__ out, int hw, int t, int cv, int splits, int blocks,
                  float* __restrict__ part, unsigned* __restrict__ bars, float scale_log2) {
    using L = F32Layout<CK, CVT>;
    constexpr int S_WARPS = 4, PV_WARPS = F_PV / 32;
    extern __shared__ uint8_t smem_raw[];
    __shared__ uint64_t full_bar[F_STAGES];
    __shared__ uint64_t empty_bar[F_STAGES];
    __shared__ uint64_t p_full[2];
    __shared__ uint64_t p_empty[2];
    __shared__ uint64_t klo_full[2];
    __shared__ uint64_t klo_empty[2];
    __shared__ uint64_t q_bar;
    __shared__ uint8_t mask_s[MAX_T + 1];
    __shared__ int any_valid_s;
    __shared__ TileRanges ranges;
    __shared__ __align__(8) float alpha_s[2][F_BQ];   // per P slot: each row's rescale of O
    __shared__ float2 ml_s[F_BQ];                     // each row's (m, l) after the last tile

    // the swizzle repeats every 1024 bytes: align the tiles to it
    const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t stage0 = q_s + L::STAGE0;
    const uint32_t p_s = q_s + L::P0;

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * F_BQ;
    const int cv0 = blockIdx.y * CVT;
    const int b = blockIdx.z / splits;
    const int split = blockIdx.z % splits;
    const int kv_len = t * hw;

    if (tid == 0) {
        any_valid_s = 0;
        for (int i = 0; i < F_STAGES; ++i) {
            mbar_init(smem_u32(&full_bar[i]), 1);
            mbar_init(smem_u32(&empty_bar[i]), S_WARPS + PV_WARPS);
        }
        for (int i = 0; i < 2; ++i) {
            mbar_init(smem_u32(&p_full[i]), 128);
            mbar_init(smem_u32(&p_empty[i]), PV_WARPS);
            mbar_init(smem_u32(&klo_full[i]), 96);
            mbar_init(smem_u32(&klo_empty[i]), 128);
        }
        mbar_init(smem_u32(&q_bar), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    for (int i = tid; i < t; i += F_THREADS) {
        const uint8_t m = slot_mask[(long)b * t + i];
        mask_s[i] = m;
        if (m) any_valid_s = 1;
    }
    __syncthreads();
    if (tid == 0) build_ranges<F_BK>(ranges, mask_s, hw, t, any_valid_s != 0);
    __syncthreads();
    // this split's live tiles: [lo, lo + n_mine) (read after setmaxnreg,
    // so that no value has to live across it)
    auto my_tiles = [&](int& lo, int& n_mine) {
        const int live = __shfl_sync(0xffffffffu, ranges.live, 0);
        lo = (int)((long)split * live / splits);
        n_mine = (int)((long)(split + 1) * live / splits) - lo;
    };
    int lo, n_mine;
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int lane = tid % 32, g = lane / 4, tq = lane % 4;

    if (wg == 3) {
        // ---- producer warpgroup: gives registers away; one thread issues every TMA load ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(F_PRODUCER_REGS));
        my_tiles(lo, n_mine);
        const int tc = tid - 3 * 128 - 32;   // warps 1-3: the converters
        if (tc >= 0 && n_mine > 0) {
            // K_lo of tile j into slot j % 2, where Q was: once the S
            // warpgroup has Q (the slots' first phase) or S of tile j - 2
            int stage = 0;
            uint32_t phase = 0;
            for (int j = 0; j < n_mine; ++j) {
                const int slot = j & 1;
                mbar_wait(smem_u32(&klo_empty[slot]), (j >> 1) & 1);
                mbar_wait(smem_u32(&full_bar[stage]), phase);
                const uint32_t ks = stage0 + stage * L::STAGE_BYTES;
                const uint32_t klo = q_s + slot * L::K_BYTES;
                // one 16-byte chunk at a time: the warpgroup kept 24 registers
#pragma unroll 1
                for (int c = tc; c < L::K_BYTES / 16; c += 96) {
                    uint4 x = lds128(ks + 16 * c);
                    x.x = tf32_lo(x.x);
                    x.y = tf32_lo(x.y);
                    x.z = tf32_lo(x.z);
                    x.w = tf32_lo(x.w);
                    sts128(klo + 16 * c, x);
                }
                fence_proxy_async();
                mbar_arrive(smem_u32(&klo_full[slot]));
                if (++stage == F_STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
        if (tid == 3 * 128 && n_mine > 0) {
            const uint32_t qb = smem_u32(&q_bar);
            mbar_expect_tx(qb, L::Q_BYTES);
            for (int cb = 0; cb < CK / 32; ++cb)
                tma_load_3d(q_s + cb * L::Q_BOX, &q_map, qb, cb * 32, q0, b);
            TileCursor cur(ranges, lo);
            int stage = 0;
            uint32_t phase = 0;
            for (int j = 0; j < n_mine; ++j, cur.next()) {
                mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
                const uint32_t fb = smem_u32(&full_bar[stage]);
                mbar_expect_tx(fb, L::STAGE_BYTES);
                const uint32_t ks = stage0 + stage * L::STAGE_BYTES;
                for (int cb = 0; cb < CK / 32; ++cb)
                    tma_load_3d(ks + cb * L::KV_BOX, &k_map, fb, cb * 32, cur.tile * F_BK, b);
                for (int c = 0; c < CVT / 32; ++c)
                    tma_load_3d(ks + L::K_BYTES + c * L::KV_BOX, &v_map, fb, cv0 + 32 * c,
                                cur.tile * F_BK, b);
                if (++stage == F_STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
        if (blocks > 1) {   // the cluster merge's two barriers count every thread
            cg::this_cluster().sync();
            cg::this_cluster().sync();
        }
        return;
    }

    if (wg == F_S_WG) {
        // ---- S warpgroup: rows r0, r0 + 8 of the block's 64 ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F_S_REGS));
        my_tiles(lo, n_mine);
        const int ts = tid - F_S_WG * 128;
        const int r0 = __shfl_sync(0xffffffffu, ts / 32, 0) * 16 + g;
        float m_run[2] = {-INFINITY, -INFINITY};   // log2 units
        float l_run[2] = {0.f, 0.f};               // this thread's share of the row sums
        if (n_mine > 0) {
            // Q as A fragments: k-step kk holds key columns 8 kk + tq (rows
            // r0, r0 + 8), then 8 kk + tq + 4
            mbar_wait(smem_u32(&q_bar), 0);
            uint32_t qh[CK / 8][4], ql[CK / 8][4];
#pragma unroll
            for (int kk = 0; kk < CK / 8; ++kk)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int row = r0 + 8 * (i % 2), col = 8 * kk + tq + 4 * (i / 2);
                    qh[kk][i] = lds32(q_s + col / 32 * L::Q_BOX + swz128(row, col % 32 / 4) +
                                      col % 4 * 4);
                    ql[kk][i] = tf32_lo(qh[kk][i]);
                }
            // Q is in registers: the converters may write K_lo where it was
            mbar_arrive(smem_u32(&klo_empty[0]));
            mbar_arrive(smem_u32(&klo_empty[1]));
            TileCursor cur(ranges, lo);
            int stage = 0;
            uint32_t phase = 0;
            for (int j = 0; j < n_mine; ++j, cur.next()) {
                const int slot = j & 1;
                mbar_wait(smem_u32(&full_bar[stage]), phase);
                mbar_wait(smem_u32(&klo_full[slot]), (j >> 1) & 1);
                const uint32_t ks = stage0 + stage * L::STAGE_BYTES;
                const uint32_t klo = q_s + slot * L::K_BYTES;

                // S = Q K^T.  s[4 n + 2 i + e]: row r0 + 8 i, position 8 n + 2 tq + e
                float s[16];
#pragma unroll
                for (int i = 0; i < 16; ++i) s[i] = 0.f;
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < CK / 8; ++kk) {
                    const uint32_t off = kk / 4 * L::KV_BOX + kk % 4 * 32;
                    const uint64_t k_hi = desc_k_major<128>(ks + off);
                    const uint64_t k_lo = desc_k_major<128>(klo + off);
                    wgmma_tf32_m64n32(s, qh[kk], k_lo, 1);
                    wgmma_tf32_m64n32(s, ql[kk], k_hi, 1);
                    wgmma_tf32_m64n32(s, qh[kk], k_hi, 1);
                }
                wgmma_commit();
                wgmma_wait<0>();
#pragma unroll
                for (int i = 0; i < 16; ++i) reg_fence(s[i]);
                mbar_arrive(smem_u32(&klo_empty[slot]));
                __syncwarp();
                if (lane == 0) mbar_arrive(smem_u32(&empty_bar[stage]));

                // mask, update m and l, p = 2^(S - m) into s
                const int p0 = cur.tile * F_BK;
                const int slot_a = p0 / hw;
                const int bnd = (slot_a + 1) * hw - p0;   // first column of the next slot
                const bool two_slots = (min(p0 + F_BK, kv_len) - 1) / hw <= slot_a + 1;
                float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
                for (int n = 0; n < 4; ++n)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = 8 * n + 2 * tq + e;
                        const bool in_range = p0 + col < kv_len;
                        const int slot_c =
                            col < bnd ? slot_a : (two_slots ? slot_a + 1 : (p0 + col) / hw);
                        const bool valid = in_range && mask_s[slot_c] != 0;
#pragma unroll
                        for (int i = 0; i < 2; ++i) {
                            float& x = s[4 * n + 2 * i + e];
                            x = !in_range ? -INFINITY : (valid ? x * scale_log2 : -1e30f);
                            mx[i] = fmaxf(mx[i], x);
                        }
                    }
                float alpha[2];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
                    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
                    alpha[i] = exp2f(m_run[i] - mx[i]);
                    m_run[i] = mx[i];
                    l_run[i] *= alpha[i];
                }
#pragma unroll
                for (int n = 0; n < 4; ++n)
#pragma unroll
                    for (int i = 0; i < 2; ++i)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            float& x = s[4 * n + 2 * i + e];
                            x = exp2f(x - m_run[i]);
                            l_run[i] += x;
                        }

                // P_hi and P_lo into the slot: position 8 n + 2 tq + e at
                // column 8 n + tq + 4 e of the row
                mbar_wait(smem_u32(&p_empty[slot]), ((j >> 1) & 1) ^ 1);
                const uint32_t ph = p_s + slot * 2 * L::P_BYTES, pl = ph + L::P_BYTES;
#pragma unroll
                for (int n = 0; n < 4; ++n)
#pragma unroll
                    for (int i = 0; i < 2; ++i)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const uint32_t off = swz128(r0 + 8 * i, 2 * n + e) + tq * 4;
                            const uint32_t x = __float_as_uint(s[4 * n + 2 * i + e]);
                            sts32(ph + off, x);
                            sts32(pl + off, tf32_lo(x));
                        }
                if (tq == 0) {
                    alpha_s[slot][r0] = alpha[0];
                    alpha_s[slot][r0 + 8] = alpha[1];
                }
                fence_proxy_async();
                mbar_arrive(smem_u32(&p_full[slot]));
                if (++stage == F_STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
            l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
        }
        const int rows = min(F_BQ, hw - q0);
        if (splits > 1 && blocks == 1) {   // the L2 merge: (m, l) to the workspace
            const Workspace ws(part, hw, cv, splits);
            float2* ml = ws.ml + split * ws.split_ml + (long)b * hw + q0;
#pragma unroll
            for (int i = 0; i < 2; ++i)
                if (tq == 0 && r0 + 8 * i < rows)
                    ml[r0 + 8 * i] = make_float2(m_run[i], l_run[i]);
            bar_sync(BAR_PV_S, F_PV + 128);
            return;
        }
        if (tq == 0) {
            ml_s[r0] = make_float2(m_run[0], l_run[0]);
            ml_s[r0 + 8] = make_float2(m_run[1], l_run[1]);
        }
        if (blocks > 1) {
            cg::this_cluster().sync();
            cg::this_cluster().sync();
        } else {
            bar_sync(BAR_PV_S, F_PV + 128);
        }
        return;
    }

    // ---- P V warpgroups: warpgroup wg, warp w, m-tile i: value columns
    // vc = wg CVT / 2 + 64 i + 16 w + 2 g (m-row g) and vc + 1 (m-row g + 8) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F_PV_REGS));
    my_tiles(lo, n_mine);
    constexpr int MT = CVT / 128;   // m-tiles of the warpgroup
    const int vc0 = wg * (CVT / 2) + 16 * __shfl_sync(0xffffffffu, (tid % 128) / 32, 0) + 2 * g;

    // o[i][4 n + 2 h + e]: value column vc0 + 64 i + h, query row 8 n + 2 tq + e
    float o[MT][32];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int x = 0; x < 32; ++x) o[i][x] = 0.f;

    if (n_mine > 0) {
        float f[32];   // a tile's P V of one m-tile, fresh each time
#pragma unroll
        for (int x = 0; x < 32; ++x) f[x] = 0.f;
        int stage = 0;
        uint32_t phase = 0;
        for (int j = 0; j < n_mine; ++j) {
            const int slot = j & 1;
            mbar_wait(smem_u32(&full_bar[stage]), phase);
            mbar_wait(smem_u32(&p_full[slot]), (j >> 1) & 1);
            const uint32_t vs = stage0 + stage * L::STAGE_BYTES + L::K_BYTES;
            const uint32_t ph = p_s + slot * 2 * L::P_BYTES, pl = ph + L::P_BYTES;
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const int vc = vc0 + 64 * i;
                const uint32_t vb = vs + vc / 32 * L::KV_BOX + vc % 4 * 4;
                uint32_t ah[F_BK / 8][4], al[F_BK / 8][4];
#pragma unroll
                for (int kk = 0; kk < F_BK / 8; ++kk)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const uint2 x = lds64(vb + swz128(8 * kk + 2 * tq + e, vc % 32 / 4));
                        ah[kk][2 * e] = x.x;
                        ah[kk][2 * e + 1] = x.y;
                        al[kk][2 * e] = tf32_lo(x.x);
                        al[kk][2 * e + 1] = tf32_lo(x.y);
                    }
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < F_BK / 8; ++kk) {
                    const uint64_t p_hi = desc_k_major<128>(ph + kk * 32);
                    const uint64_t p_lo = desc_k_major<128>(pl + kk * 32);
                    wgmma_tf32_m64n64(f, ah[kk], p_lo, kk > 0);
                    wgmma_tf32_m64n64(f, al[kk], p_hi, 1);
                    wgmma_tf32_m64n64(f, ah[kk], p_hi, 1);
                }
                wgmma_commit();
                wgmma_wait<0>();
#pragma unroll
                for (int x = 0; x < 32; ++x) reg_fence(f[x]);
#pragma unroll
                for (int kk = 0; kk < F_BK / 8; ++kk)
#pragma unroll
                    for (int x = 0; x < 4; ++x) {
                        reg_fence(ah[kk][x]);
                        reg_fence(al[kk][x]);
                    }
#pragma unroll
                for (int n = 0; n < 8; ++n) {
                    const float2 a = *reinterpret_cast<const float2*>(&alpha_s[slot][8 * n + 2 * tq]);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        float* x = o[i] + 4 * n + 2 * h;
                        x[0] = fmaf(x[0], a.x, f[4 * n + 2 * h]);
                        x[1] = fmaf(x[1], a.y, f[4 * n + 2 * h + 1]);
                    }
                }
            }
            __syncwarp();
            if (lane == 0) {
                mbar_arrive(smem_u32(&p_empty[slot]));
                mbar_arrive(smem_u32(&empty_bar[stage]));
            }
            if (++stage == F_STAGES) {
                stage = 0;
                phase ^= 1;
            }
        }
    }

    // O's rows below `rows` to `to`, rows `stride` floats apart, value
    // column c at to[c - cv0]
    auto store_o = [&](float* to, int stride, int rows, bool scale_by_l) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int q = 8 * n + 2 * tq + e;
                if (q >= rows) continue;
                const float inv = scale_by_l ? 1.f / ml_s[q].y : 1.f;
#pragma unroll
                for (int i = 0; i < MT; ++i)
                    *reinterpret_cast<float2*>(to + (long)q * stride + vc0 + 64 * i) =
                        make_float2(o[i][4 * n + e] * inv, o[i][4 * n + 2 + e] * inv);
            }
    };
    if (splits == 1) {
        bar_sync(BAR_PV_S, F_PV + 128);   // the S warpgroup's (m, l) in ml_s
        store_o(out + ((long)block_index<2>() * hw + block_index<0>() * F_BQ) * cv +
                    block_index<1>() * CVT,
                cv, min(F_BQ, hw - q0), true);
        return;
    }
    // the S warpgroup's (m, l): ml_s in a cluster, the workspace otherwise
    split_epilogue<CVT, F_BQ, L::STRIDE, BAR_PV_S, F_PV + 128>(
        reinterpret_cast<float*>(smem_raw + (q_s - smem_u32(smem_raw))), ml_s,
        [&](float* to, int stride, float2*, int rows) { store_o(to, stride, rows, false); }, hw,
        cv, splits, blocks, part, bars, out, tid);
}

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
                cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A [batch, rows, cols] tensor of `type` (bf16 unless given) read in boxes
// of [1, box_rows, box_cols]; rows past `rows` read as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int cols, long rows, int batch, int box_cols,
                CUtensorMapSwizzle swizzle,
                CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, int box_rows = 64) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t size = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
    const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
    const cuuint64_t strides[2] = {(cuuint64_t)cols * size, (cuuint64_t)cols * rows * size};
    const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// How a launch splits each output tile: `splits` blocks, as one cluster a
// tile (blocks == splits) or without clusters (blocks == 1), then with
// split_epilogue's workspace `part` and `bars`.
struct Split {
    int splits, blocks;
    float* part;
    unsigned* bars;
};

// Sets the kernel's shared memory and fills `cfg` for a grid with clusters
// of `blocks` blocks (1: no cluster), launched cooperatively where
// `cooperative`: all its blocks resident at once, or the launch refused
// (cudaErrorCooperativeLaunchTooLarge).
template <typename Kernel>
cudaError_t read_config(Kernel kernel, int smem, int threads, dim3 grid, int blocks,
                        bool cooperative, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                        cudaLaunchAttribute& attr) {
    if (blocks > 1) {
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = 1;
        attr.val.clusterDim.y = 1;
        attr.val.clusterDim.z = blocks;
    } else {
        attr.id = cudaLaunchAttributeCooperative;
        attr.val.cooperative = 1;
    }
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = blocks > 1 || cooperative ? 1 : 0;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// A refused call leaves its error as the last one: clear it, so that the
// next launch's cudaGetLastError() reports only its own.
cudaError_t cleared(cudaError_t err) {
    if (err != cudaSuccess) cudaGetLastError();
    return err;
}

// Launches `kernel` (blocks of `threads`, `bq` query rows by `cvt` value
// columns) with its arguments up to `out`, then (hw, t, cv, the split,
// scale_log2).  A split merged through L2 (blocks == 1 < splits) waits
// inside the launch for its tile's other blocks: it is launched
// cooperatively.
template <typename Kernel, typename T>
cudaError_t launch_read(Kernel kernel, int smem, int threads, int bq, int cvt,
                        const CUtensorMap* maps, const void* mask, T* out, int batch, int hw,
                        int t, int cv, Split sp, float scale_log2, cudaStream_t stream) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    const dim3 grid((hw + bq - 1) / bq, cv / cvt, batch * sp.splits);
    const uint8_t* mask_p = static_cast<const uint8_t*>(mask);
    void* args[] = {const_cast<CUtensorMap*>(&maps[0]), const_cast<CUtensorMap*>(&maps[1]),
                    const_cast<CUtensorMap*>(&maps[2]), &mask_p, &out, &hw, &t, &cv,
                    &sp.splits, &sp.blocks, &sp.part, &sp.bars, &scale_log2};
    cudaError_t err = read_config(kernel, smem, threads, grid, sp.blocks, sp.blocks < sp.splits,
                                  stream, cfg, attr);
    if (err == cudaSuccess) err = cudaLaunchKernelExC(&cfg, (const void*)kernel, args);
    return err == cudaSuccess ? cudaGetLastError() : cleared(err);
}

// How many clusters of `blocks` blocks of the kernel the card holds at
// once; for blocks == 1, how many blocks.
template <typename Kernel>
cudaError_t max_clusters(Kernel kernel, int smem, int threads, int blocks, int* count) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err =
        read_config(kernel, smem, threads, dim3(1, 1, blocks), blocks, false, 0, cfg, attr);
    if (err == cudaSuccess && blocks > 1)
        err = cudaOccupancyMaxActiveClusters(count, (const void*)kernel, &cfg);
    if (err == cudaSuccess && blocks == 1) {
        int per_sm = 0, sms = 0, device = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
        if (err == cudaSuccess) err = cudaGetDevice(&device);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        *count = per_sm * sms;
    }
    return cleared(err);
}

template <int CK, int CVT>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* mask, void* out,
                      int batch, int hw, int t, int cv, Split sp, cudaStream_t stream) {
    using L = Layout<CK, CVT>;
    const CUtensorMapSwizzle swz =
        L::SWZ == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    CUtensorMap maps[3];
    if (!encode_map(&maps[0], q, CK, hw, batch, L::CKB, swz) ||
        !encode_map(&maps[1], k, CK, (long)t * hw, batch, L::CKB, swz) ||
        !encode_map(&maps[2], v, cv, (long)t * hw, batch, 64, CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;
    return launch_read(memory_read_tc<CK, CVT>, L::SMEM, THREADS, BQ, CVT, maps, mask,
                       static_cast<__nv_bfloat16*>(out), batch, hw, t, cv, sp,
                       LOG2E / sqrtf((float)CK), stream);
}

template <int CK, int CVT>
cudaError_t launch_f32tc(const void* q, const void* k, const void* v, const void* mask, void* out,
                         int batch, int hw, int t, int cv, Split sp, cudaStream_t stream) {
    using L = F32Layout<CK, CVT>;
    const CUtensorMapSwizzle swz = CU_TENSOR_MAP_SWIZZLE_128B;
    const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    CUtensorMap maps[3];
    if (!encode_map(&maps[0], q, CK, hw, batch, 32, swz, f32, F_BQ) ||
        !encode_map(&maps[1], k, CK, (long)t * hw, batch, 32, swz, f32, F_BK) ||
        !encode_map(&maps[2], v, cv, (long)t * hw, batch, 32, swz, f32, F_BK))
        return cudaErrorInvalidValue;
    return launch_read(memory_read_f32tc<CK, CVT>, L::SMEM, F_THREADS, F_BQ, CVT, maps, mask,
                       static_cast<float*>(out), batch, hw, t, cv, sp, LOG2E / sqrtf((float)CK),
                       stream);
}

bool read_args_ok(int batch, int hw, int t, int cv, const Split& sp) {
    const bool workspace = sp.part != nullptr && sp.bars != nullptr;
    const bool split_ok = sp.blocks == sp.splits || (sp.blocks == 1 && workspace);
    return batch > 0 && hw > 0 && t > 0 && t <= MAX_T && cv > 0 && cv % 128 == 0 &&
           sp.splits > 0 && sp.splits <= MAX_SPLITS && split_ok &&
           (long)batch * sp.splits <= 65535 && (long)t * hw <= (1l << 31) - BK;
}

template <int N>
using Int = std::integral_constant<int, N>;

// fn(Int<Ck>, Int<CVT>) for the instantiated widths: Ck 32 or 128; CVT
// 256, or 128 where Cv is not a multiple of 256.
template <typename Fn>
cudaError_t with_widths(int ck, int cv, Fn fn) {
    const bool wide = cv % 256 == 0;
    switch (ck) {
        case 32: return wide ? fn(Int<32>(), Int<256>()) : fn(Int<32>(), Int<128>());
        case 128: return wide ? fn(Int<128>(), Int<256>()) : fn(Int<128>(), Int<128>());
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q [B, HW, Ck], k [B, T*HW, Ck], v [B, T*HW, Cv], mask [B, T] uint8, out
// [B, HW, Cv]; all contiguous fp32 on one device, 16-byte aligned.  Ck in
// {32, 128}, Cv a multiple of 128, T <= 256.  splits <= 8 blocks per output
// tile: blocks == splits launches one cluster a tile (a size the card
// holds: otvm_memory_read_max_clusters); blocks == 1 with splits > 1 merges
// through `part`, an fp32 workspace of splits * B * HW * (Cv + 2) floats,
// and `bars`, 2 * B * ceil(HW / 64) * (Cv / CVT) uint32 counters (CVT =
// 256, or 128 where Cv is not a multiple of 256), 0 before the first
// launch (launches leave them fit for the next), and is launched
// cooperatively: the whole grid on the card at once, or refused
// (cudaErrorCooperativeLaunchTooLarge).  Launches on `stream`, returns the
// launch's error.
extern "C" int otvm_memory_read_f32(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int batch, int hw, int t, int ck,
                                    int cv, int splits, int blocks, void* part, void* bars,
                                    void* stream) {
    const Split sp{splits, blocks, static_cast<float*>(part), static_cast<unsigned*>(bars)};
    if (!read_args_ok(batch, hw, t, cv, sp)) return (int)cudaErrorInvalidValue;
    return (int)with_widths(ck, cv, [&](auto ck_, auto cvt) {
        return launch_f32tc<decltype(ck_)::value, decltype(cvt)::value>(
            q, k, v, mask, out, batch, hw, t, cv, sp, static_cast<cudaStream_t>(stream));
    });
}

// The same in bf16, 16-byte aligned; its query tiles are 128 rows, so
// `bars` holds 2 * B * ceil(HW / 128) * (Cv / CVT) counters.
extern "C" int otvm_memory_read_bf16(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int batch, int hw, int t, int ck,
                                     int cv, int splits, int blocks, void* part, void* bars,
                                     void* stream) {
    const Split sp{splits, blocks, static_cast<float*>(part), static_cast<unsigned*>(bars)};
    if (!read_args_ok(batch, hw, t, cv, sp)) return (int)cudaErrorInvalidValue;
    return (int)with_widths(ck, cv, [&](auto ck_, auto cvt) {
        return launch_tc<decltype(ck_)::value, decltype(cvt)::value>(
            q, k, v, mask, out, batch, hw, t, cv, sp, static_cast<cudaStream_t>(stream));
    });
}

// *count = the most clusters of `blocks` (2..8) blocks of the read kernel
// for (fp32 or bf16, Ck, Cv) that the current card holds at once
// (cudaOccupancyMaxActiveClusters), or for blocks == 1 the most blocks;
// returns the query's error.
extern "C" int otvm_memory_read_max_clusters(int fp32, int ck, int cv, int blocks, int* count) {
    if (blocks < 1 || blocks > MAX_SPLITS || cv <= 0 || cv % 128 != 0 || count == nullptr)
        return (int)cudaErrorInvalidValue;
    return (int)with_widths(ck, cv, [&](auto ck_, auto cvt) {
        constexpr int CK = decltype(ck_)::value, CVT = decltype(cvt)::value;
        return fp32 ? max_clusters(memory_read_f32tc<CK, CVT>, F32Layout<CK, CVT>::SMEM,
                                   F_THREADS, blocks, count)
                    : max_clusters(memory_read_tc<CK, CVT>, Layout<CK, CVT>::SMEM, THREADS,
                                   blocks, count);
    });
}
