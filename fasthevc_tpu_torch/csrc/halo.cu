// K16: the tile-column halo exchange of the sharded pipelines.
//
// Replaces fasthevc_tpu/parallel/sharded.py _ppermute_halo (:46): each tile
// shard receives the left neighbour's last wl columns and the right
// neighbour's first wr columns of a set of planes, and a shard at a picture
// bound replicates its own edge column instead (:59-63).  One launch builds
// the extended planes [left wl | own | right wr] of every plane of the set
// (luma, both chromas, the int maps of the deblocking), whatever their
// element size, or, for the process transport, packs each plane's first and
// last columns into the contiguous send buffers.
//
// A plane is described by its output (pointer, rows, width, element size)
// and up to three column segments, each read from its own strided source:
// output column j of a segment reads source column col0 + step * j, so
// step 0 replicates one column (the picture bound).  In process the left
// and right segments read the neighbour ranks' planes directly (same
// device); across processes they read the received strips.  One thread per
// output element, a grid-stride loop over every plane of the set.
//
// Bound on the H100: device-memory traffic, each output element read once
// and written once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 16;
constexpr int kSegs = 3;

struct Seg {
  const char* ptr;      // source base
  long long stride;     // source elements per row
  int col0, step, width;
};

struct Plane {
  char* out;
  long long start;      // first output element of the plane in the set
  int rows, width, esize;
  Seg seg[kSegs];
};

struct Set {
  Plane p[kMaxPlanes];
  int n;
  long long total;
};

__device__ __forceinline__ void copy_elem(char* dst, const char* src,
                                          int esize) {
  switch (esize) {
    case 1: *dst = *src; break;
    case 2: *reinterpret_cast<short*>(dst) =
                *reinterpret_cast<const short*>(src); break;
    case 4: *reinterpret_cast<int*>(dst) =
                *reinterpret_cast<const int*>(src); break;
    default: *reinterpret_cast<long long*>(dst) =
                 *reinterpret_cast<const long long*>(src); break;
  }
}

__global__ void halo_kernel(const Set set) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < set.total; e += stride) {
    int k = 0;
    while (k + 1 < set.n && e >= set.p[k + 1].start) ++k;
    const Plane& pl = set.p[k];
    // a plane holds fewer than 2^31 elements: 32-bit division
    const int local = (int)(e - pl.start);
    const int row = local / pl.width;
    int col = local - row * pl.width;
    int s = 0;
    while (s + 1 < kSegs && col >= pl.seg[s].width) {
      col -= pl.seg[s].width;
      ++s;
    }
    const Seg& sg = pl.seg[s];
    const long long src_col = sg.col0 + (long long)sg.step * col;
    copy_elem(pl.out + (long long)local * pl.esize,
              sg.ptr + ((long long)row * sg.stride + src_col) * pl.esize,
              pl.esize);
  }
}

}  // namespace

// desc: n planes of 4 + 5 * 3 int64 each: out pointer, rows, width, element
// size, then per segment (pointer, row stride, col0, step, width); a
// segment of width 0 is unused.
extern "C" int fhv_halo(const long long* desc, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n > kMaxPlanes) return (int)cudaErrorInvalidValue;
  Set set;
  set.n = n;
  long long total = 0;
  for (int k = 0; k < n; ++k) {
    const long long* d = desc + (size_t)k * (4 + 5 * kSegs);
    Plane& pl = set.p[k];
    pl.out = reinterpret_cast<char*>(d[0]);
    pl.rows = (int)d[1];
    pl.width = (int)d[2];
    pl.esize = (int)d[3];
    pl.start = total;
    for (int s = 0; s < kSegs; ++s) {
      const long long* g = d + 4 + 5 * s;
      pl.seg[s].ptr = reinterpret_cast<const char*>(g[0]);
      pl.seg[s].stride = g[1];
      pl.seg[s].col0 = (int)g[2];
      pl.seg[s].step = (int)g[3];
      pl.seg[s].width = (int)g[4];
    }
    total += (long long)pl.rows * pl.width;
  }
  set.total = total;
  if (total <= 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  halo_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(set);
  return (int)cudaGetLastError();
}
