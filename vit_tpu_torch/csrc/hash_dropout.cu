// Counter-hash dropout, y = x * keep(seed, coordinates), in one pass.
//
// Replaces no Pallas kernel: vit_tpu/ops/dropout.py::hash_dropout is jnp
// uint32 arithmetic that XLA fuses into one pass, and the port's plain
// version (vit_tpu_torch/ops/dropout.py::_coord_hash) runs the same hash op
// by op in int64, about 20 full-size passes a call. This kernel is that
// fusion, bit for bit: the hash starts at seed * SEED_MULT; each axis adds
// (coordinate + offset) * its multiplier, then x ^= x >> 15, x *= M1; the
// murmur3 finaliser ends it; an element is kept when its bits are below the
// threshold, and y = x * m in fp32, rounded to x's dtype, with m = 1/keep
// rounded to x's dtype or 0 (what `x * mask.to(x.dtype)` computes: a dropped
// element is x * 0, so the sign of zero and NaN/inf propagate).
//
// What bounds it on the H100: the bytes, 4 an element in bf16 and fp16 (read
// x, write y), 8 in fp32; 3.35 TB/s moves an element in ~1.2 ns of the card,
// room for ~17 integer operations an element at the SMs' integer rate. The
// finaliser and the last axis's step are ~12 of them, so the rest of the
// hash must not be paid per element.
//
// What the design does about it: a warp walks chunks of the flat tensor, 16
// steps of 16 bytes a lane each (a 512-byte coalesced row of the warp a
// step), the loads of four steps in flight before they are used; as many
// blocks as fit on the card at once take the chunks a grid apart. Each lane
// keeps a cursor: its column in the last axis, the leading axes' coordinates
// and their partial hash, which it updates when the column wraps (one axis
// step a row; all leading axes only when an inner coordinate carries), so an
// element pays the last axis's step, the finaliser and the scale. The vectors
// lie on the flat tensor, not on rows: where the last axis is not a multiple
// of a vector (odd widths: T 197), a vector may cross a row end, and every
// lane then takes, per element, this row's or the next row's partial hash by
// a select, so no lane of a warp branches apart. The seed is a kernel
// argument, or read from device memory (a captured CUDA graph replays with
// whatever seed its buffer holds).
//
// Replicas (the vmapped sweep: one seed per replica): x's first axis is then
// the replica axis, unhashed; replica r's elements start from seeds[r] and
// hash their coordinates in the other axes, what each replica draws alone.
// The cursor starts a row's hash from its replica's seed, so an element pays
// the same as without replicas.
#include <cuda_fp16.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;        // steps whose loads are in flight together
constexpr int CHUNK_STEPS = 16;  // steps of one warp's contiguous chunk
constexpr int MAX_HASHED = 6;    // vit_tpu/ops/dropout.py::_AXIS_MULTS
constexpr int MAX_AXES = MAX_HASHED + 1;  // and a replica axis
constexpr unsigned SEED_MULT = 0x7FEB352Du;
constexpr unsigned M1 = 0x85EBCA6Bu;

// vit_tpu/ops/dropout.py::_AXIS_MULTS, by hashed axis
constexpr unsigned AXIS_MULTS[MAX_HASHED] = {0x9E3779B1u, 0x85EBCA6Bu, 0xC2B2AE35u,
                                             0x27D4EB2Fu, 0x165667B1u, 0xD3A2646Du};

// A kernel argument: the kernel indexes it by unrolled constants, so it is
// read from the constant bank, and an axis's multiplier costs no lookup.
struct Shape {
  int dims[MAX_AXES];
  unsigned offs[MAX_AXES];  // each axis's coordinate offset, int32 as uint32
  unsigned mult[MAX_AXES];  // each axis's multiplier (its hashed axis's; 0: replicas)
};

// Where every hash starts: x0 for one seed; with replicas (REP 1: axis 0 is
// the replica axis), seeds[r] * SEED_MULT.
struct Start {
  unsigned x0;
  const int* seeds;
};

// One axis's step of the coordinate hash; idx is coordinate + offset.
__device__ __forceinline__ unsigned axis_step(unsigned x, unsigned idx, unsigned mult) {
  x += idx * mult;
  x ^= x >> 15;
  return x * M1;
}

// Element types as their bits: 16 bytes hold VEC of them.
template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int VEC = 4;
  static constexpr int BITS = 32;
  __device__ static float to_f(unsigned b) { return __uint_as_float(b); }
  __device__ static unsigned from_f(float f) { return __float_as_uint(f); }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static constexpr int BITS = 16;
  __device__ static float to_f(unsigned b) {
    return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(b)));
  }
  __device__ static unsigned from_f(float f) { return __bfloat16_as_ushort(__float2bfloat16_rn(f)); }
};
template <> struct Elem<__half> {
  static constexpr int VEC = 8;
  static constexpr int BITS = 16;
  __device__ static float to_f(unsigned b) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
  }
  __device__ static unsigned from_f(float f) { return __half_as_ushort(__float2half_rn(f)); }
};

// The element rule: x * m in fp32, rounded to x's dtype (x, the result: bits).
template <typename T>
__device__ __forceinline__ unsigned scaled(unsigned x, float m) {
  return Elem<T>::from_f(Elem<T>::to_f(x) * m);
}

// Where a lane stands: the column in the last axis, the leading axes'
// coordinates, the hash of all leading axes but the innermost (outer) and
// of all of them (row).
template <int N> struct Cursor {
  int col;
  int c[N > 1 ? N - 1 : 1];
  unsigned outer, row;
};

template <int N, int REP>
__device__ __forceinline__ void rehash(Cursor<N>& cu, const Start& st, const Shape& sh) {
  if constexpr (N >= 2) {
    unsigned x = REP ? static_cast<unsigned>(st.seeds[cu.c[0]]) * SEED_MULT : st.x0;
#pragma unroll
    for (int a = REP; a < N - 2; ++a)
      x = axis_step(x, static_cast<unsigned>(cu.c[a]) + sh.offs[a], sh.mult[a]);
    cu.outer = x;
    cu.row = N - 2 < REP ? x  // the innermost leading axis is the replica axis
             : axis_step(x, static_cast<unsigned>(cu.c[N - 2]) + sh.offs[N - 2], sh.mult[N - 2]);
  } else {
    cu.row = st.x0;
  }
}

// The cursor at flat element i.
template <int N, int REP>
__device__ __forceinline__ void seek(Cursor<N>& cu, long long i, const Start& st,
                                     const Shape& sh) {
  const long long rows = i / sh.dims[N - 1];
  cu.col = static_cast<int>(i - rows * sh.dims[N - 1]);
  if constexpr (N >= 2) {
    long long r = rows;
#pragma unroll
    for (int a = N - 2; a >= 0; --a) {
      const long long q = r / sh.dims[a];
      cu.c[a] = static_cast<int>(r - q * sh.dims[a]);
      r = q;
    }
  }
  rehash<N, REP>(cu, st, sh);
}

// The next row: one axis step, or all leading axes when a coordinate carries
// or the row is the next replica's.
template <int N, int REP>
__device__ __forceinline__ void next_row(Cursor<N>& cu, const Start& st, const Shape& sh) {
  if constexpr (N >= 2) {
    if (++cu.c[N - 2] == sh.dims[N - 2]) {
      cu.c[N - 2] = 0;
#pragma unroll
      for (int a = N - 3; a >= 0; --a) {
        if (++cu.c[a] < sh.dims[a]) break;
        cu.c[a] = 0;
      }
      rehash<N, REP>(cu, st, sh);
    } else if constexpr (N - 2 < REP) {
      rehash<N, REP>(cu, st, sh);
    } else {
      cu.row = axis_step(cu.outer, static_cast<unsigned>(cu.c[N - 2]) + sh.offs[N - 2],
                         sh.mult[N - 2]);
    }
  }
}

struct Keep {
  unsigned threshold;  // keep iff bits < threshold
  float scale;         // 1/keep rounded to x's dtype
  int len;             // the last axis's length
  unsigned last_off, last_mult;
};

__device__ __forceinline__ float keep_factor(unsigned row, int col, const Keep& k) {
  const unsigned bits = vtt::fmix32(axis_step(row, static_cast<unsigned>(col) + k.last_off,
                                              k.last_mult));
  return bits < k.threshold ? k.scale : 0.0f;
}

// put(e, keep factor) for the n elements from the cursor on, walking a copy
// of it across row ends: rows shorter than a vector, and the tensor's tail.
template <int N, int REP, typename Put>
__device__ __forceinline__ void walk(Cursor<N> w, long long n, const Start& st, const Shape& sh,
                                     const Keep& k, Put put) {
  for (long long e = 0; e < n; ++e) {
    if (w.col == k.len) {
      w.col = 0;
      next_row<N, REP>(w, st, sh);
    }
    put(e, keep_factor(w.row, w.col, k));
    ++w.col;
  }
}

// Element e of a 16-byte vector held as four words, and its bits put back.
template <typename T>
__device__ __forceinline__ unsigned elem_of(const unsigned (&w)[4], int e) {
  if constexpr (Elem<T>::BITS == 32) return w[e];
  else return (w[e >> 1] >> ((e & 1) * 16)) & 0xFFFFu;
}

template <typename T>
__device__ __forceinline__ void put_elem(unsigned (&w)[4], int e, unsigned b) {
  if constexpr (Elem<T>::BITS == 32) w[e] = b;
  else w[e >> 1] |= b << ((e & 1) * 16);
}

template <typename T, int N, int REP>
__global__ void __launch_bounds__(THREADS)
hash_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long numel, Shape sh,
                    long long chunks, unsigned seed, const int* __restrict__ seed_ptr,
                    unsigned threshold, float scale) {
  using E = Elem<T>;
  constexpr int VEC = E::VEC;
  constexpr int STRIDE = 32 * VEC;  // elements a warp covers in one step
  const Start st{(seed_ptr && !REP ? static_cast<unsigned>(*seed_ptr) : seed) * SEED_MULT,
                 seed_ptr};
  const int L = sh.dims[N - 1];
  // How a vector meets the rows, the same for every lane: never across a row
  // end (L a multiple of VEC), across at most one (L >= VEC), or across many.
  const int rows_met = L % VEC == 0 ? 0 : (L >= VEC ? 1 : 2);
  const Keep k{threshold, scale, L, sh.offs[N - 1], sh.mult[N - 1]};
  const long long warps = static_cast<long long>(gridDim.x) * (THREADS / 32);
  for (long long chunk = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
       chunk < chunks; chunk += warps) {
    long long i = chunk * CHUNK_STEPS * STRIDE + (threadIdx.x & 31) * VEC;
    if (i >= numel) return;
    Cursor<N> cu;
    seek<N, REP>(cu, i, st, sh);
#pragma unroll 1
    for (int it = 0; it < CHUNK_STEPS; it += UNROLL) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long j = i + static_cast<long long>(u) * STRIDE;
        if (j + VEC <= numel) v[u] = __ldg(reinterpret_cast<const uint4*>(x + j));
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i >= numel) return;
        if (i + VEC <= numel) {
          const unsigned in[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
          unsigned out[4] = {0u, 0u, 0u, 0u};
          if (rows_met == 0) {  // the vector lies in one row
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              put_elem<T>(out, e, scaled<T>(elem_of<T>(in, e),
                                            keep_factor(cu.row, cu.col + e, k)));
          } else if (rows_met == 1) {  // in this row, then maybe the next: select
            Cursor<N> nx = cu;
            next_row<N, REP>(nx, st, sh);
            const int split = L - cu.col;  // elements before the row end
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const bool here = e < split;
              put_elem<T>(out, e, scaled<T>(elem_of<T>(in, e),
                                            keep_factor(here ? cu.row : nx.row,
                                                        here ? cu.col + e : e - split, k)));
            }
          } else {  // rows shorter than a vector
            walk<N, REP>(cu, VEC, st, sh, k, [&](long long e, float m) {
              const int j = static_cast<int>(e);
              put_elem<T>(out, j, scaled<T>(elem_of<T>(in, j), m));
            });
          }
          *reinterpret_cast<uint4*>(y + i) = make_uint4(out[0], out[1], out[2], out[3]);
        } else {  // the tensor's last, partial vector
          using Bits = typename std::conditional<E::BITS == 32, unsigned, unsigned short>::type;
          const Bits* xs = reinterpret_cast<const Bits*>(x) + i;
          Bits* ys = reinterpret_cast<Bits*>(y) + i;
          walk<N, REP>(cu, numel - i, st, sh, k, [&](long long e, float m) {
            ys[e] = static_cast<Bits>(scaled<T>(xs[e], m));
          });
        }
        i += STRIDE;
        cu.col += STRIDE;
        if (cu.col >= L) {
          if (L >= STRIDE / 4) {  // at most five rows on
            do {
              cu.col -= L;
              next_row<N, REP>(cu, st, sh);
            } while (cu.col >= L);
          } else if (i < numel) {
            seek<N, REP>(cu, i, st, sh);
          }
        }
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// A warp per chunk of CHUNK_STEPS steps; as many blocks as are resident at
// once (or fewer), each walking chunks a grid apart. N axes, REP of them the
// replicas': 1 to MAX_HASHED hashed axes (the entry point checks it).
template <typename T, int N, int REP>
void launch(const void* x, void* y, long long numel, const Shape& sh, unsigned seed,
            const int* seed_ptr, unsigned threshold, float scale, cudaStream_t s) {
  if constexpr (N - REP >= 1 && N - REP <= MAX_HASHED) {
    constexpr long long CHUNK = CHUNK_STEPS * 32 * Elem<T>::VEC;
    static int per_sm = 0;  // resident blocks of this instantiation on one SM
    if (per_sm == 0) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hash_dropout_kernel<T, N, REP>,
                                                    THREADS, 0);
      per_sm = std::max(per_sm, 1);
    }
    const long long chunks = (numel + CHUNK - 1) / CHUNK;
    const long long blocks = std::min<long long>((chunks + THREADS / 32 - 1) / (THREADS / 32),
                                                 static_cast<long long>(sm_count()) * per_sm);
    hash_dropout_kernel<T, N, REP><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), numel, sh, chunks, seed, seed_ptr,
        threshold, scale);
  }
}

// The replicas' axis is a template argument: without one the kernel keeps no
// trace of it.
template <typename T, int N>
void launch_axes(int rep, const void* x, void* y, long long numel, const Shape& sh,
                 unsigned seed, const int* seed_ptr, unsigned threshold, float scale,
                 cudaStream_t s) {
  if (rep) launch<T, N, 1>(x, y, numel, sh, seed, seed_ptr, threshold, scale, s);
  else launch<T, N, 0>(x, y, numel, sh, seed, seed_ptr, threshold, scale, s);
}

template <typename T>
int launch_rank(int rank, int rep, const void* x, void* y, long long numel, const Shape& sh,
                unsigned seed, const int* seed_ptr, unsigned threshold, float scale,
                cudaStream_t s) {
  switch (rank) {
    case 1: launch_axes<T, 1>(rep, x, y, numel, sh, seed, seed_ptr, threshold, scale, s); break;
    case 2: launch_axes<T, 2>(rep, x, y, numel, sh, seed, seed_ptr, threshold, scale, s); break;
    case 3: launch_axes<T, 3>(rep, x, y, numel, sh, seed, seed_ptr, threshold, scale, s); break;
    case 4: launch_axes<T, 4>(rep, x, y, numel, sh, seed, seed_ptr, threshold, scale, s); break;
    case 5: launch_axes<T, 5>(rep, x, y, numel, sh, seed, seed_ptr, threshold, scale, s); break;
    case 6: launch_axes<T, 6>(rep, x, y, numel, sh, seed, seed_ptr, threshold, scale, s); break;
    case 7: launch_axes<T, 7>(rep, x, y, numel, sh, seed, seed_ptr, threshold, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: contiguous, 16-byte aligned, numel > 0 elements of shape dims[:rank];
// rep 1: dims[0] replicas, replica r hashing dims[1:rank] from seed_ptr[r];
// rep 0: one seed, seed_ptr's device int32 or `seed` where it is null; 1 to
// 6 hashed axes. offs: each axis's coordinate offset (int32 bits); dtype 0
// fp32, 1 bf16, 2 fp16.
extern "C" int hash_dropout(const void* x, void* y, long long numel, int rank, int rep, int d0,
                            int d1, int d2, int d3, int d4, int d5, int d6, unsigned o0,
                            unsigned o1, unsigned o2, unsigned o3, unsigned o4, unsigned o5,
                            unsigned o6, unsigned seed, const void* seed_ptr, unsigned threshold,
                            float scale, int dtype, void* stream) {
  if ((rep != 0 && (rep != 1 || seed_ptr == nullptr)) || rank - rep < 1 || rank - rep > MAX_HASHED)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh{{d0, d1, d2, d3, d4, d5, d6}, {o0, o1, o2, o3, o4, o5, o6}, {}};
  for (int a = rep; a < rank; ++a) sh.mult[a] = AXIS_MULTS[a - rep];
  const int* sp = static_cast<const int*>(seed_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_rank<float>(rank, rep, x, y, numel, sh, seed, sp, threshold, scale, s);
    case 1:
      return launch_rank<__nv_bfloat16>(rank, rep, x, y, numel, sh, seed, sp, threshold, scale,
                                        s);
    case 2: return launch_rank<__half>(rank, rep, x, y, numel, sh, seed, sp, threshold, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
