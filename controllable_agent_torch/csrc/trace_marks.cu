// Marker kernels for the port's device spans (utils/trace.py).
//
// A host span cannot enter a CUDA graph: it runs when the graph is
// captured, never when it is replayed. What a replay does run is the
// graph's nodes. So a device span is a pair of these empty kernels,
// launched on the current stream at the span's begin and end: inside a
// capture they become nodes of the graph and run on every replay, and the
// profiler records them on the device's timeline like any other kernel.
// Each span has an id, and each id its own pair of kernels, so that the
// span can be told from the kernel's name alone (trace_begin_<id>,
// trace_end_<id>; utils/trace.py keeps the map from id to span name).
//
// Replaces no TPU kernel (the JAX package has no device spans). A mark does
// no work: one block of one thread that returns. Its cost is one launch,
// about a microsecond of device time, which the trace leaves out of every
// span's busy time.

#include <cuda_runtime.h>

#define TRACE_MARK_PAIR(n)                       \
  extern "C" __global__ void trace_begin_##n() {} \
  extern "C" __global__ void trace_end_##n() {}

TRACE_MARK_PAIR(0)
TRACE_MARK_PAIR(1)
TRACE_MARK_PAIR(2)
TRACE_MARK_PAIR(3)
TRACE_MARK_PAIR(4)
TRACE_MARK_PAIR(5)
TRACE_MARK_PAIR(6)
TRACE_MARK_PAIR(7)
TRACE_MARK_PAIR(8)
TRACE_MARK_PAIR(9)
TRACE_MARK_PAIR(10)
TRACE_MARK_PAIR(11)
TRACE_MARK_PAIR(12)
TRACE_MARK_PAIR(13)
TRACE_MARK_PAIR(14)
TRACE_MARK_PAIR(15)

namespace {

using Mark = void (*)();

const Mark kBegin[] = {trace_begin_0,  trace_begin_1,  trace_begin_2,  trace_begin_3,
                       trace_begin_4,  trace_begin_5,  trace_begin_6,  trace_begin_7,
                       trace_begin_8,  trace_begin_9,  trace_begin_10, trace_begin_11,
                       trace_begin_12, trace_begin_13, trace_begin_14, trace_begin_15};
const Mark kEnd[] = {trace_end_0,  trace_end_1,  trace_end_2,  trace_end_3,
                     trace_end_4,  trace_end_5,  trace_end_6,  trace_end_7,
                     trace_end_8,  trace_end_9,  trace_end_10, trace_end_11,
                     trace_end_12, trace_end_13, trace_end_14, trace_end_15};
constexpr int kMarks = sizeof(kBegin) / sizeof(kBegin[0]);

}  // namespace

extern "C" {

// The number of span ids that have a pair of marks.
int trace_mark_ids() { return kMarks; }

// Launch span id's begin (begin != 0) or end mark on the stream; returns
// the launch's CUDA error (0 when it was launched or captured).
int trace_mark(int id, int begin, void* stream) {
  if (id < 0 || id >= kMarks) return static_cast<int>(cudaErrorInvalidValue);
  const Mark mark = begin ? kBegin[id] : kEnd[id];
  cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(mark), dim3(1), dim3(1),
                                     nullptr, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
