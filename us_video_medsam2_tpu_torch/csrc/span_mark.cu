// The program spans' marks (utils/profiling.py): a one-thread kernel that a
// span launches on the current stream at its start and at its end, eagerly or
// captured into a CUDA graph, whose replays then run it.
//
// table is int64 [1 + MAX_SPANS][2]. table[0] is the flag: while it is 0 a
// mark returns at once, so a graph's marks cost a launch and one load while
// nothing records. Row 1 + slot holds the span's last start and its summed
// time, in ns of %globaltimer: a start mark stores the timer, an end mark adds
// the timer less the start. The stream runs the marks in order, so no two
// touch a row at once.
//
// usm_globaltimer_steps gives the timer's resolution: one thread spins on it
// and writes the size of each of its first n changes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<int64_t>(t);
}

__global__ void span_mark_kernel(int64_t* table, int slot, int end) {
  if (*reinterpret_cast<volatile int64_t*>(table) == 0) return;
  const int64_t now = global_ns();
  int64_t* row = table + 2 * (1 + slot);
  if (end) {
    row[1] += now - row[0];
  } else {
    row[0] = now;
  }
}

__global__ void globaltimer_steps_kernel(int64_t* out, int n) {
  int64_t last = global_ns();
  for (int i = 0; i < n; ++i) {
    int64_t t;
    do {
      t = global_ns();
    } while (t == last);
    out[i] = t - last;
    last = t;
  }
}

}  // namespace

extern "C" int usm_span_mark(void* table, int slot, int end, void* stream) {
  span_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<int64_t*>(table), slot, end);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int usm_globaltimer_steps(void* out, int n, void* stream) {
  globaltimer_steps_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<int64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
