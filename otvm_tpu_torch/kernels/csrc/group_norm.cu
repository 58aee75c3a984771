// GroupNorm of frozen serving models for Hopper (sm_90a), CUDA C++ with a
// plain C entry.
//
// Replaces no TPU kernel: the JAX package's GroupNorm (otvm_tpu/nn/layers.py
// GroupNorm32) is plain XLA.  Added because torch's CUDA GroupNorm gives each
// (sample, group) one block for its statistics (RowwiseMomentsCUDAKernel):
// 32 blocks on the H100's 132 SMs at batch 1, each walking up to 4.18 M
// values of one group with 2-byte loads and a serial Welford chain.  In the
// stage-4 stream at 1088x1920 in bf16 that kernel took ~43 ms of a ~110 ms
// frame on the card.
//
// Computes, over an NCHW-contiguous x [N, C, *] in G groups of D = C / G
// channels, y = act((x - mean) * rsqrt(var + eps) * gamma_c + beta_c), with
// mean and biased variance over each (n, g)'s D * H * W values, as
// nn.GroupNorm does; act is none, ReLU or LeakyReLU(slope): the activation
// that follows the norm in the model, fused.  bf16 or fp32 in and out; the
// statistics and the affine in fp32, the output rounded once.
//
// What bounds it: bytes.  The statistics read x once, the apply reads it
// again and writes y: 3 x elements x dtype size over 3.35 TB/s on an H100.
// Each value costs a few flops, far below what the card does per byte.
//
// Design:
//   * In NCHW each (n, g) group is one contiguous run of L = D * H * W
//     values.  The wrapper cuts each run into `chunks` chunks of `chunk`
//     values (a multiple of one 16-byte load for each of the block's
//     threads), so that the grid (chunks, N * G) is a few waves of the
//     card's resident blocks whatever N * G is.
//   * group_norm_stats: each block reads its chunk with 16-byte loads,
//     UNROLL in flight a thread.  A batch of loads is reduced in registers
//     (its mean, then its squared deviations from it) and merged into the
//     thread's running (count, mean, M2) by Chan's formula; the threads'
//     moments merge across the warp and the block by the same formula, in
//     a fixed order.  Deviations from local means keep the sum of squares
//     free of cancellation over millions of values.  The block writes one
//     partial (count, mean, M2).
//   * group_norm_apply: the same grid.  Each block merges its group's
//     partials (12 bytes a chunk, from L2) in a fixed order, so every block
//     of a group gets the same bits, takes rstd = rsqrt(M2 / count + eps),
//     and writes act(x * a_c + b_c) with a_c = rstd * gamma_c and b_c =
//     beta_c - mean * a_c in fp32 (torch's fused form), with 16-byte loads
//     and stores.
//   * The partials live in a scratch tensor that the wrapper makes (from a
//     CUDA graph's pool under capture).  No atomics and no counters to
//     reset: runs and replays give the same bits.
//   * A start that is not 16-byte aligned and a ragged end are read and
//     written value by value (the PPM's 1x1 to 6x6 maps, odd H * W), as is
//     a whole chunk whose input and output differ in their alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;       // 16-byte loads in flight a thread
constexpr int MAX_GRID_Y = 65535;

template <typename T> struct Traits;
template <> struct Traits<float> {
    static constexpr int VEC = 4;       // values in 16 bytes
    __device__ static float load(float v) { return v; }
    __device__ static float store(float v) { return v; }
};
template <> struct Traits<__nv_bfloat16> {
    static constexpr int VEC = 8;
    __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
    __device__ static __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out) {
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < Traits<T>::VEC; ++j) out[j] = Traits<T>::load(v[j]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* in) {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < Traits<T>::VEC; ++j) v[j] = Traits<T>::store(in[j]);
    return raw;
}

struct Moments {
    float n, mean, m2;          // count, mean, sum of squared deviations
};

// Chan's merge of two sets' moments; either may be empty.
__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
    const float n = a.n + b.n;
    if (n == 0.f) return a;
    const float wb = b.n / n;
    const float delta = b.mean - a.mean;
    return {n, fmaf(delta, wb, a.mean), a.m2 + b.m2 + delta * delta * a.n * wb};
}

template <int M>
__device__ __forceinline__ Moments moments_of(const float (&v)[M]) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < M; ++j) s += v[j];
    const float mean = s * (1.f / M);
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
        const float d = v[j] - mean;
        m2 = fmaf(d, d, m2);
    }
    return {static_cast<float>(M), mean, m2};
}

__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const Moments other{__shfl_down_sync(0xffffffffu, m.n, o),
                            __shfl_down_sync(0xffffffffu, m.mean, o),
                            __shfl_down_sync(0xffffffffu, m.m2, o)};
        m = merge(m, other);
    }
    return m;
}

// The block's moments, merged in a fixed order, returned to every thread.
__device__ __forceinline__ Moments block_merge(Moments m) {
    __shared__ Moments warp_moments[WARPS];
    __shared__ Moments total;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    m = warp_merge(m);
    if (lane == 0) warp_moments[warp] = m;
    __syncthreads();
    if (warp == 0) {
        m = warp_merge(lane < WARPS ? warp_moments[lane] : Moments{0.f, 0.f, 0.f});
        if (lane == 0) total = m;
    }
    __syncthreads();
    return total;
}

struct Geometry {
    long long len;      // values a group: D * H * W
    long long chunk;    // values a block
    unsigned hw;        // values a channel
    int d;              // channels a group
    int groups;         // G
};

// A block's chunk: [lo, lo + n) of its group, whose first `head` values
// precede the first 16-byte boundary, then `nvec` 16-byte vectors, then
// the ragged end from `tail` on.
template <typename T>
struct Chunk {
    long long base, lo, n, head, nvec, tail;

    __device__ Chunk(const T* x, const Geometry& g, bool vectorize) {
        base = static_cast<long long>(blockIdx.y) * g.len;
        lo = static_cast<long long>(blockIdx.x) * g.chunk;
        n = min(g.chunk, g.len - lo);
        const uintptr_t addr = reinterpret_cast<uintptr_t>(x + base + lo);
        head = vectorize ? min(static_cast<long long>(((16 - (addr & 15)) & 15) / sizeof(T)), n)
                         : n;
        nvec = (n - head) / Traits<T>::VEC;
        tail = head + nvec * Traits<T>::VEC;
    }
    // the value-by-value part: index i of [0, head + n - tail) -> offset in the chunk
    __device__ long long scalar(long long i) const { return i < head ? i : tail + (i - head); }
    __device__ long long scalars() const { return head + n - tail; }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
group_norm_stats(const T* __restrict__ x, float* __restrict__ part, const Geometry g) {
    constexpr int VEC = Traits<T>::VEC;
    const Chunk<T> ck(x, g, true);
    const T* p = x + ck.base + ck.lo;
    const uint4* pv = reinterpret_cast<const uint4*>(p + ck.head);
    Moments acc{0.f, 0.f, 0.f};
    long long v = threadIdx.x;
    for (; v + (UNROLL - 1) * THREADS < ck.nvec; v += UNROLL * THREADS) {
        uint4 raw[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) raw[u] = __ldg(pv + v + u * THREADS);
        float vals[UNROLL * VEC];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) unpack<T>(raw[u], vals + u * VEC);
        acc = merge(acc, moments_of(vals));
    }
    for (; v < ck.nvec; v += THREADS) {
        float vals[VEC];
        unpack<T>(__ldg(pv + v), vals);
        acc = merge(acc, moments_of(vals));
    }
    for (long long i = threadIdx.x; i < ck.scalars(); i += THREADS)
        acc = merge(acc, Moments{1.f, Traits<T>::load(p[ck.scalar(i)]), 0.f});
    const Moments m = block_merge(acc);
    if (threadIdx.x == 0) {
        float* out = part + 3 * (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x);
        out[0] = m.n;
        out[1] = m.mean;
        out[2] = m.m2;
    }
}

template <int ACT>
__device__ __forceinline__ float activate(float y, float slope) {
    if (ACT == 1) return y < 0.f ? 0.f : y;
    if (ACT == 2) return y < 0.f ? y * slope : y;
    return y;
}

// Channel c's scale and shift, a and b of y = x * a + b.
template <typename T>
struct Affine {
    const T* gamma;
    const T* beta;
    float mean, rstd;
    int cached = -1;
    float a = 0.f, b = 0.f;

    __device__ __forceinline__ void at(int c) {
        if (c == cached) return;
        cached = c;
        a = gamma ? rstd * Traits<T>::load(gamma[c]) : rstd;
        b = fmaf(-a, mean, beta ? Traits<T>::load(beta[c]) : 0.f);
    }
};

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
group_norm_apply(const T* __restrict__ x, const T* __restrict__ gamma,
                 const T* __restrict__ beta, const float* __restrict__ part, T* __restrict__ y,
                 const Geometry g, const float eps, const float slope) {
    constexpr int VEC = Traits<T>::VEC;
    const float* gp = part + 3 * static_cast<long long>(blockIdx.y) * gridDim.x;
    Moments acc{0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += THREADS)
        acc = merge(acc, Moments{gp[3 * i], gp[3 * i + 1], gp[3 * i + 2]});
    const Moments m = block_merge(acc);
    Affine<T> aff{gamma, beta, m.mean, rsqrtf(m.m2 / m.n + eps)};

    const int c0 = static_cast<int>(blockIdx.y % g.groups) * g.d;    // the group's first channel
    const uintptr_t apart = reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(y);
    const Chunk<T> ck(x, g, (apart & 15) == 0);
    const T* p = x + ck.base + ck.lo;
    T* q = y + ck.base + ck.lo;
    const uint4* pv = reinterpret_cast<const uint4*>(p + ck.head);
    uint4* qv = reinterpret_cast<uint4*>(q + ck.head);
    for (long long v = threadIdx.x; v < ck.nvec; v += THREADS) {
        const unsigned off = static_cast<unsigned>(ck.lo + ck.head + v * VEC);
        unsigned c = off / g.hw, r = off - c * g.hw;
        float vals[VEC];
        unpack<T>(__ldg(pv + v), vals);
        if (r + VEC <= g.hw) {              // one channel
            aff.at(c0 + static_cast<int>(c));
#pragma unroll
            for (int j = 0; j < VEC; ++j) vals[j] = activate<ACT>(fmaf(vals[j], aff.a, aff.b), slope);
        } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                for (; r >= g.hw; r -= g.hw) ++c;
                aff.at(c0 + static_cast<int>(c));
                vals[j] = activate<ACT>(fmaf(vals[j], aff.a, aff.b), slope);
                ++r;
            }
        }
        qv[v] = pack<T>(vals);
    }
    for (long long i = threadIdx.x; i < ck.scalars(); i += THREADS) {
        const long long j = ck.scalar(i);
        aff.at(c0 + static_cast<int>(static_cast<unsigned>(ck.lo + j) / g.hw));
        q[j] = Traits<T>::store(activate<ACT>(fmaf(Traits<T>::load(p[j]), aff.a, aff.b), slope));
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y, float* part,
                   int groups_total, const Geometry& g, int chunks, float eps, int act,
                   float slope, cudaStream_t stream) {
    const dim3 grid(chunks, groups_total);
    const T* xt = static_cast<const T*>(x);
    const T* gt = static_cast<const T*>(gamma);
    const T* bt = static_cast<const T*>(beta);
    T* yt = static_cast<T*>(y);
    group_norm_stats<T><<<grid, THREADS, 0, stream>>>(xt, part, g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (act == 1)
        group_norm_apply<T, 1><<<grid, THREADS, 0, stream>>>(xt, gt, bt, part, yt, g, eps, slope);
    else if (act == 2)
        group_norm_apply<T, 2><<<grid, THREADS, 0, stream>>>(xt, gt, bt, part, yt, g, eps, slope);
    else
        group_norm_apply<T, 0><<<grid, THREADS, 0, stream>>>(xt, gt, bt, part, yt, g, eps, slope);
    return cudaGetLastError();
}

}  // namespace

// GroupNorm over x [N, C, *] (NCHW-contiguous) into y of the same shape:
// groups_total = N * G groups of d = C / G channels of hw values, each cut
// into `chunks` chunks of `chunk` values; part holds 3 * groups_total *
// chunks floats.  gamma and beta ([C], x's dtype) may be null.  act: 0
// none, 1 ReLU, 2 LeakyReLU(slope).  Two launches on `stream`; returns the
// first launch error (cudaGetLastError), 0 on success.
extern "C" int otvm_group_norm(int bf16, const void* x, const void* gamma, const void* beta,
                               void* y, void* part, int groups_total, int groups, int d,
                               long long hw, long long chunk, int chunks, float eps, int act,
                               float slope, void* stream) {
    const long long len = static_cast<long long>(d) * hw;
    if (groups_total < 1 || groups_total > MAX_GRID_Y || groups < 1 || groups_total % groups ||
        d < 1 || hw < 1 || len >= (1ll << 31) || chunk < 1 || chunks < 1 ||
        static_cast<long long>(chunks) * chunk < len || static_cast<long long>(chunks - 1) * chunk >= len ||
        act < 0 || act > 2 || x == nullptr || y == nullptr || part == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const Geometry g{len, chunk, static_cast<unsigned>(hw), d, groups};
    float* p = static_cast<float*>(part);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(
        bf16 ? launch<__nv_bfloat16>(x, gamma, beta, y, p, groups_total, g, chunks, eps, act, slope, s)
             : launch<float>(x, gamma, beta, y, p, groups_total, g, chunks, eps, act, slope, s));
}
