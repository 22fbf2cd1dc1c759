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
// device); across processes they read the received strips.
//
// Bound on the H100: device-memory traffic, each output element read once
// and written once.  At the mesh's shapes that is under a microsecond
// (1.88 MB for an interior rank's 1080p source exchange), below what one
// launch takes, so the design is about issue work, not bandwidth.
//
// The row form (`fhv_halo_rows`, the one the routes launch): a CTA a
// (plane, band of kBandRows rows), which finds its plane once from the
// prefix table of bands in the launch's parameter block, and a warp a
// row, walking the row's three segments in turn.  A segment whose source
// and destination byte addresses agree modulo 16 copies in 16-byte
// vectors between a scalar head and tail (the uint8 source exchange's
// 32-576-byte rows, the ME halo, the decimated planes, the recon's 8/4
// int32 columns); otherwise, and for the 1- and 4-column map and SAO
// strips, it copies one element a lane.  A replicating segment loads its
// one element once a row (lane 0) and splats it through 16-byte stores.
//
// The earlier form (`fhv_halo`, counter `halo`, which no route launches):
// one thread per output element over every plane of the set, each thread
// finding its plane and segment by searches and its row by a division, to
// copy one 1-8 byte element; a warp moved 32 bytes an instruction on the
// uint8 planes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 16;
constexpr int kSegs = 3;
constexpr int kDesc = 4 + 5 * kSegs;  // int64 fields of a plane descriptor
constexpr int kBandRows = 8;          // rows a CTA of the row form, a warp each

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

// ---- the row form --------------------------------------------------------

struct RowSeg {
  const char* src;  // the segment's first source byte in row 0
  long long pitch;  // source bytes a row
  int dst;          // byte offset of the segment in an output row
  int bytes;        // bytes a row (0: unused)
  int step;         // 1: copy; 0: replicate the element at src
};

struct RowPlane {
  char* out;
  long long pitch;  // output bytes a row
  int rows, esize;
  RowSeg seg[kSegs];
};

struct RowSet {
  RowPlane p[kMaxPlanes];
  int band0[kMaxPlanes + 1];  // the first band (CTA) of each plane
  int n;
};

__device__ __forceinline__ unsigned long long load_elem(const char* p,
                                                        int esize) {
  switch (esize) {
    case 1: return *reinterpret_cast<const unsigned char*>(p);
    case 2: return *reinterpret_cast<const unsigned short*>(p);
    case 4: return *reinterpret_cast<const unsigned int*>(p);
    default: return *reinterpret_cast<const unsigned long long*>(p);
  }
}

__device__ __forceinline__ void store_elem(char* p, unsigned long long v,
                                           int esize) {
  switch (esize) {
    case 1: *reinterpret_cast<unsigned char*>(p) = (unsigned char)v; break;
    case 2: *reinterpret_cast<unsigned short*>(p) = (unsigned short)v; break;
    case 4: *reinterpret_cast<unsigned int*>(p) = (unsigned int)v; break;
    default: *reinterpret_cast<unsigned long long*>(p) = v; break;
  }
}

// Bytes before dst's next 16-byte boundary, at most `bytes` (a multiple of
// the element size: every address here is element-aligned).
__device__ __forceinline__ int head_bytes(const char* dst, int bytes) {
  const int h = (int)((16u - (unsigned)(reinterpret_cast<uintptr_t>(dst)
                                        & 15u)) & 15u);
  return h < bytes ? h : bytes;
}

// One warp copies one row's segment of `bytes` bytes.
__device__ __forceinline__ void copy_seg(char* dst, const char* src,
                                         int bytes, int esize, int lane) {
  const unsigned mis = (unsigned)((reinterpret_cast<uintptr_t>(dst) ^
                                   reinterpret_cast<uintptr_t>(src)) & 15u);
  if (mis != 0) {
    // the scalar path: one element a lane
    for (int i = lane * esize; i < bytes; i += 32 * esize)
      copy_elem(dst + i, src + i, esize);
    return;
  }
  const int head = head_bytes(dst, bytes);
  const int nvec = (bytes - head) >> 4;
  const int t0 = head + (nvec << 4);
  if (lane * esize < head) copy_elem(dst + lane * esize, src + lane * esize,
                                     esize);
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int v = lane; v < nvec; v += 32) d4[v] = __ldg(s4 + v);
  if (t0 + lane * esize < bytes)
    copy_elem(dst + t0 + lane * esize, src + t0 + lane * esize, esize);
}

// One warp writes one row's segment of `bytes` bytes, all the element at
// src: lane 0 loads it, the warp splats it.
__device__ __forceinline__ void fill_seg(char* dst, const char* src,
                                         int bytes, int esize, int lane) {
  unsigned long long v = lane == 0 ? load_elem(src, esize) : 0ull;
  v = __shfl_sync(0xffffffffu, v, 0);
  unsigned long long w = v;  // the element repeated through 8 bytes
  if (esize == 1) w |= w << 8;
  if (esize <= 2) w |= w << 16;
  if (esize <= 4) w |= w << 32;
  const int head = head_bytes(dst, bytes);
  const int nvec = (bytes - head) >> 4;
  const int t0 = head + (nvec << 4);
  if (lane * esize < head) store_elem(dst + lane * esize, v, esize);
  const uint4 pat = make_uint4((unsigned)w, (unsigned)(w >> 32), (unsigned)w,
                               (unsigned)(w >> 32));
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int i = lane; i < nvec; i += 32) d4[i] = pat;
  if (t0 + lane * esize < bytes) store_elem(dst + t0 + lane * esize, v, esize);
}

__global__ void __launch_bounds__(kBandRows * 32)
    halo_rows_kernel(const __grid_constant__ RowSet set) {
  // the CTA's plane, once, from the prefix table of bands (uniform)
  int k = 0;
  while (k + 1 < set.n && (int)blockIdx.x >= set.band0[k + 1]) ++k;
  const RowPlane& pl = set.p[k];
  const int row = ((int)blockIdx.x - set.band0[k]) * kBandRows +
                  (int)(threadIdx.x >> 5);
  if (row >= pl.rows) return;  // a whole warp leaves
  const int lane = threadIdx.x & 31;
  char* out = pl.out + (long long)row * pl.pitch;
#pragma unroll
  for (int s = 0; s < kSegs; ++s) {
    const RowSeg& sg = pl.seg[s];
    if (sg.bytes == 0) continue;
    const char* src = sg.src + (long long)row * sg.pitch;
    if (sg.step)
      copy_seg(out + sg.dst, src, sg.bytes, pl.esize, lane);
    else
      fill_seg(out + sg.dst, src, sg.bytes, pl.esize, lane);
  }
}

}  // namespace

// The earlier form.  desc: n planes of 4 + 5 * 3 int64 each: out pointer, rows, width, element
// size, then per segment (pointer, row stride, col0, step, width); a
// segment of width 0 is unused.
extern "C" int fhv_halo(const long long* desc, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n > kMaxPlanes) return (int)cudaErrorInvalidValue;
  Set set;
  set.n = n;
  long long total = 0;
  for (int k = 0; k < n; ++k) {
    const long long* d = desc + (size_t)k * kDesc;
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

// The row form; desc as fhv_halo's (element sizes 1, 2, 4 or 8; a step of
// 0 or 1; the segments' widths summing to the output width).
extern "C" int fhv_halo_rows(const long long* desc, int n,
                             cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n > kMaxPlanes) return (int)cudaErrorInvalidValue;
  RowSet set{};
  set.n = n;
  int bands = 0;
  for (int k = 0; k < n; ++k) {
    const long long* d = desc + (size_t)k * kDesc;
    RowPlane& pl = set.p[k];
    const long long width = d[2], es = d[3];
    if (d[1] < 0 || width < 0 || (es != 1 && es != 2 && es != 4 && es != 8))
      return (int)cudaErrorInvalidValue;
    pl.out = reinterpret_cast<char*>(d[0]);
    pl.rows = (int)d[1];
    pl.esize = (int)es;
    pl.pitch = width * es;
    long long col = 0;
    for (int s = 0; s < kSegs; ++s) {
      const long long* g = d + 4 + 5 * s;
      RowSeg& sg = pl.seg[s];
      sg.src = reinterpret_cast<const char*>(g[0]) + g[2] * es;
      sg.pitch = g[1] * es;
      sg.dst = (int)(col * es);
      sg.bytes = (int)(g[4] * es);
      sg.step = g[3] != 0;
      if (g[4] < 0 || (g[3] != 0 && g[3] != 1))
        return (int)cudaErrorInvalidValue;
      col += g[4];
    }
    if (col != width) return (int)cudaErrorInvalidValue;
    set.band0[k] = bands;
    bands += (pl.rows + kBandRows - 1) / kBandRows;
  }
  set.band0[n] = bands;
  if (bands == 0) return 0;
  halo_rows_kernel<<<bands, kBandRows * 32, 0, stream>>>(set);
  return (int)cudaGetLastError();
}
