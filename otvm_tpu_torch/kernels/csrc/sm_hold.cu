// A kernel that holds SMs for a set time: the other tenant of the memory
// read's co-residency test (otvm_tpu_torch/tools/coresidency.py).
//
// Each block reserves `smem` bytes of dynamic shared memory (200 KB or
// more leaves no room on its SM for a block of the read) and one thread
// spins on %globaltimer for `ns` nanoseconds, then the block ends.  Before
// it spins, it adds one to a counter in mapped host memory, so the host
// can wait until every block is resident before it enqueues the read.

#include <cuda_runtime.h>

#include <ctime>

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

__global__ void hold_sms(unsigned* arrived, unsigned long long ns) {
    extern __shared__ unsigned char reserved[];
    if (threadIdx.x == 0) {
        reserved[0] = 0;
        const unsigned long long start = global_ns();
        atomicAdd_system(arrived, 1u);
        __threadfence_system();
        while (global_ns() - start < ns) __nanosleep(1000);
    }
    __syncthreads();
}

unsigned* arrived_host = nullptr;   // mapped host memory, one counter

}  // namespace

// Launches `blocks` blocks of 32 threads with `smem` bytes of dynamic
// shared memory each on `stream`, each spinning for `ns` nanoseconds, and
// waits on the host (at most `wait_ns`) until all of them are resident.
// *resident = how many were; returns a CUDA error, or
// cudaErrorLaunchTimeout where not all became resident in time.
extern "C" int otvm_hold_sms(int blocks, int smem, long long ns, long long wait_ns, void* stream,
                             int* resident) {
    if (blocks < 1 || smem < 0 || ns < 0 || resident == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSuccess;
    if (arrived_host == nullptr)
        err = cudaHostAlloc(reinterpret_cast<void**>(&arrived_host), sizeof(unsigned),
                            cudaHostAllocMapped);
    if (err != cudaSuccess) return (int)err;
    unsigned* arrived_dev = nullptr;
    err = cudaHostGetDevicePointer(reinterpret_cast<void**>(&arrived_dev), arrived_host, 0);
    if (err != cudaSuccess) return (int)err;
    *reinterpret_cast<volatile unsigned*>(arrived_host) = 0;
    err = cudaFuncSetAttribute(hold_sms, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    hold_sms<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        arrived_dev, static_cast<unsigned long long>(ns));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // wait on the host's clock, reading the mapped counter: no CUDA call,
    // so nothing here waits behind the held SMs
    const volatile unsigned* seen = arrived_host;
    timespec t0, t;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (;;) {
        *resident = (int)*seen;
        if (*resident >= blocks) return (int)cudaSuccess;
        clock_gettime(CLOCK_MONOTONIC, &t);
        if ((t.tv_sec - t0.tv_sec) * 1000000000ll + (t.tv_nsec - t0.tv_nsec) > wait_ns)
            return (int)cudaErrorLaunchTimeout;
    }
}
