// Space-time memory read for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces otvm_tpu/kernels/memory_attn.py::memory_read_pallas (the Pallas
// TPU kernel, body _flash_kernel).  Computes, per batch element b,
//     out[q, :] = softmax_k( mask(Q[q] . K[k] / sqrt(Ck)) ) . V[k, :]
// over the bank flattened to T*HW memory positions, with an online softmax
// (running max, running sum, rescaled fp32 accumulator), so the [HW, T*HW]
// score matrix never reaches device memory.  Masked slots score -1e30 and p
// is not zeroed, as in memory_read_xla: with at least one valid slot this is
// the Pallas result; with none it is the uniform average (Pallas gives NaN).
//
// What bounds it on an H100 at 512p, steady state (HW = 1024, 5 valid slots
// of T = 6, Ck = 128, Cv = 512): 2 * 1024 * 5120 * (128 + 512) = 6.7 GFLOP,
// 6.8 us on the bf16 tensor cores (989 TFLOP/s); the bytes (q, the valid
// bank, out: ~7.8 MB in bf16) take 2.3 us at 3.35 TB/s.  It is
// compute-bound.
//
// This first design is simple and exact rather than fast:
//   * grid (HW / 32 query rows, Cv / 128 value columns, B); 256 threads;
//   * the KV axis is a loop inside the block, in tiles of 64 positions staged
//     in shared memory as fp32; S = Q K^T is recomputed for every Cv slice;
//   * all products are fp32 FMAs on the CUDA cores, also for bf16 inputs
//     (converted on load) - no mma.sync, wgmma or TMA, no cp.async
//     pipelining.  It gives up the tensor cores (15x the fp32 rate) and
//     overlap of loads with math; that redesign is later work;
//   * KV tiles that lie wholly in masked slots are skipped when at least one
//     slot is valid (their p is exactly 0 then), so a steady-state read
//     costs the valid slots only, for any mask, prefix or not.
// As in the Pallas kernel, p is rounded to the value dtype before the PV
// product, and the output takes q's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;       // query rows per block (16 row pairs)
constexpr int BK = 64;       // memory positions per KV tile
constexpr int CVS = 128;     // value columns per block
constexpr int THREADS = 256; // 16 x 16: ty owns 2 rows, tx owns columns tx + 16 j
constexpr int MAX_T = 256;   // bank slots

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// max / sum over the 16 lanes that share a row pair (one half-warp)
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

template <int CK>
constexpr size_t smem_bytes() {
    return sizeof(float) * (BQ * (CK + 1) + BK * (CK + 1) + BK * CVS + BQ * BK);
}

template <typename T, int CK>
__global__ void __launch_bounds__(THREADS)
memory_read_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ slot_mask,
                   T* __restrict__ out, int hw, int t, int cv, float scale) {
    extern __shared__ float smem[];
    float* Qs = smem;                    // [BQ][CK + 1]  (+1: no bank conflicts)
    float* Ks = Qs + BQ * (CK + 1);      // [BK][CK + 1]
    float* Vs = Ks + BK * (CK + 1);      // [BK][CVS]
    float* Ps = Vs + BK * CVS;           // [BQ][BK]
    __shared__ uint8_t mask_s[MAX_T];
    __shared__ int any_valid_s;

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int q0 = blockIdx.x * BQ;
    const int cv0 = blockIdx.y * CVS;
    const int b = blockIdx.z;
    const long kv_len = (long)t * hw;

    const T* qb = q + (long)b * hw * CK;
    const T* kb = k + (long)b * kv_len * CK;
    const T* vb = v + (long)b * kv_len * cv;

    if (tid == 0) any_valid_s = 0;
    __syncthreads();
    for (int i = tid; i < t; i += THREADS) {
        const uint8_t m = slot_mask[(long)b * t + i];
        mask_s[i] = m;
        if (m) any_valid_s = 1;
    }
    for (int i = tid; i < BQ * CK; i += THREADS) {
        const int r = i / CK, c = i % CK;
        Qs[r * (CK + 1) + c] = (q0 + r < hw) ? to_f(qb[(long)(q0 + r) * CK + c]) : 0.f;
    }
    __syncthreads();
    const bool any_valid = any_valid_s != 0;

    const int r0 = ty * 2;  // this thread's rows: r0, r0 + 1
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float acc[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (long k0 = 0; k0 < kv_len; k0 += BK) {
        const int n_k = (int)min((long)BK, kv_len - k0);
        if (any_valid) {  // block-uniform: every thread takes the same branch
            bool live = false;
            for (long s = k0 / hw; s <= (k0 + n_k - 1) / hw; ++s) live |= mask_s[s] != 0;
            if (!live) continue;
        }
        for (int i = tid; i < BK * CK; i += THREADS) {
            const int r = i / CK, c = i % CK;
            Ks[r * (CK + 1) + c] = (r < n_k) ? to_f(kb[(k0 + r) * CK + c]) : 0.f;
        }
        for (int i = tid; i < BK * CVS; i += THREADS) {
            const int r = i / CVS, c = i % CVS;
            Vs[r * CVS + c] = (r < n_k) ? to_f(vb[(k0 + r) * cv + cv0 + c]) : 0.f;
        }
        __syncthreads();

        // S tile: rows r0, r0 + 1; columns tx + 16 j
        float s[2][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[0][j] = s[1][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < CK; ++d) {
            const float qa = Qs[r0 * (CK + 1) + d];
            const float qc = Qs[(r0 + 1) * (CK + 1) + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float kk = Ks[(tx + 16 * j) * (CK + 1) + d];
                s[0][j] = fmaf(qa, kk, s[0][j]);
                s[1][j] = fmaf(qc, kk, s[1][j]);
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            const bool in_range = c < n_k;
            const bool valid = in_range && mask_s[(k0 + c) / hw] != 0;
#pragma unroll
            for (int i = 0; i < 2; ++i)
                s[i][j] = !in_range ? -INFINITY : (valid ? s[i][j] * scale : -1e30f);
        }

        // online softmax, one row pair per half-warp
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
            mx = half_warp_max(mx);
            const float m_new = fmaxf(m_run[i], mx);
            const float alpha = expf(m_run[i] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_new);
                psum += p;
                Ps[(r0 + i) * BK + tx + 16 * j] = to_f(from_f<T>(p));
            }
            l_run[i] = l_run[i] * alpha + half_warp_sum(psum);
            m_run[i] = m_new;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
        }
        __syncthreads();

        // acc += P V over this tile (out-of-range rows have p = 0 and V = 0)
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            const float p0 = Ps[r0 * BK + kk];
            const float p1 = Ps[(r0 + 1) * BK + kk];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float vv = Vs[kk * CVS + tx + 16 * j];
                acc[0][j] = fmaf(p0, vv, acc[0][j]);
                acc[1][j] = fmaf(p1, vv, acc[1][j]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = q0 + r0 + i;
        if (r >= hw) continue;
        T* ob = out + ((long)b * hw + r) * cv + cv0;
#pragma unroll
        for (int j = 0; j < 8; ++j) ob[tx + 16 * j] = from_f<T>(acc[i][j] / l_run[i]);
    }
}

template <typename T, int CK>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int batch, int hw, int t, int cv, cudaStream_t stream) {
    auto kernel = memory_read_kernel<T, CK>;
    const size_t smem = smem_bytes<CK>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((hw + BQ - 1) / BQ, cv / CVS, batch);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const uint8_t*>(mask), static_cast<T*>(out), hw, t, cv,
        1.0f / sqrtf((float)CK));
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_ck(const void* q, const void* k, const void* v, const void* mask,
                        void* out, int batch, int hw, int t, int ck, int cv,
                        cudaStream_t stream) {
    switch (ck) {
        case 32: return launch<T, 32>(q, k, v, mask, out, batch, hw, t, cv, stream);
        case 128: return launch<T, 128>(q, k, v, mask, out, batch, hw, t, cv, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q [B, HW, Ck], k [B, T*HW, Ck], v [B, T*HW, Cv], mask [B, T] uint8, out
// [B, HW, Cv]; all contiguous, on one device, q/k/v/out of one dtype
// (is_bf16: bfloat16, else float32).  Ck in {32, 128}, Cv a multiple of
// 128, T <= 256.  Launches on `stream` and returns cudaGetLastError().
extern "C" int otvm_memory_read(const void* q, const void* k, const void* v, const void* mask,
                                void* out, int batch, int hw, int t, int ck, int cv,
                                int is_bf16, void* stream) {
    if (batch <= 0 || hw <= 0 || t <= 0 || t > MAX_T || cv <= 0 || cv % CVS != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        is_bf16 ? dispatch_ck<__nv_bfloat16>(q, k, v, mask, out, batch, hw, t, ck, cv, s)
                : dispatch_ck<float>(q, k, v, mask, out, batch, hw, t, ck, cv, s);
    return (int)err;
}
