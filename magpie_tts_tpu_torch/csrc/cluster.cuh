// Helpers of the probe kernels that meet in thread-block clusters
// (probe_attend.cu, probe_gemv.cu): the cluster rank, stores into another
// CTA's shared memory, the cluster barriers, the %globaltimer clock of the
// phase stamps, and the host side's raise of a kernel's shared-memory limit.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The cluster: this CTA's rank, stores into another CTA's shared memory, and
// the barrier of every thread of the cluster (writes before it, remote ones
// included, are seen by every thread of the cluster after it).
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// Stores into CTA `rank`'s shared memory at this CTA's address p.
__device__ __forceinline__ unsigned cluster_addr(const float* p, int rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(float* p, float v, int rank) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(cluster_addr(p, rank)), "f"(v)
               : "memory");
}
__device__ __forceinline__ void st_cluster2(float* p, float x, float y, int rank) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(cluster_addr(p, rank)), "f"(x),
               "f"(y)
               : "memory");
}
// A CTA may write another's shared memory only once that CTA runs: each
// arrives (relaxed) as it starts and waits before its first remote store.
__device__ __forceinline__ void cluster_arrive_started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_started() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}
__device__ __forceinline__ void st_cluster4(float* p, const float (&v)[4], int rank) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(cluster_addr(p, rank)),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}
// A transaction barrier (mbarrier) in this CTA's shared memory, which other
// CTAs of the cluster complete with st.async: init (one thread; then
// fence_mbar_init before the cluster barrier that publishes it), one arrival
// that expects `bytes`, and the wait for a phase. A wait that has not ended
// after 2 s traps (as probe_attend.cu's grid_sync): bytes that never land
// fail the launch instead of hanging it.
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, int bytes) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state)
               : "r"((unsigned)__cvta_generic_to_shared(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(bar);
  unsigned long long t0 = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const unsigned long long t = global_ns();
    if (t0 == 0) {
      t0 = t;
    } else if (t - t0 > 2000000000ull) {
      __trap();
    }
  }
}
// 16 bytes into CTA `rank`'s shared memory at this CTA's address p, counted
// on that CTA's transaction barrier at this CTA's address bar.
__device__ __forceinline__ void st_async_cluster4(float* p, const float (&v)[4],
                                                  unsigned long long* bar, int rank) {
  unsigned rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rbar)
               : "r"((unsigned)__cvta_generic_to_shared(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(cluster_addr(p, rank)),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(rbar)
      : "memory");
}
// The two halves of cluster_sync. A wait waits for the arrival of every
// thread of the cluster that has not exited, so a CTA whose stores another
// CTA waits for may arrive (release) and exit.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive_release();
  cluster_wait_acquire();
}

// Raises a kernel's dynamic shared-memory limit to the largest size asked on
// this device, never lowering it; 0 or a CUDA error.
inline int raise_smem(const void* kernel, int smem) {
  struct Entry {
    const void* kernel;
    int device, smem;
  };
  static std::mutex mu;
  static Entry limits[32];
  static int n_limits = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  Entry* limit = nullptr;
  for (int i = 0; i < n_limits; ++i) {
    if (limits[i].kernel == kernel && limits[i].device == dev) limit = &limits[i];
  }
  if (limit != nullptr && smem <= limit->smem) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (limit != nullptr) {
    limit->smem = smem;
  } else if (n_limits < 32) {
    limits[n_limits++] = Entry{kernel, dev, smem};
  }
  return 0;
}
