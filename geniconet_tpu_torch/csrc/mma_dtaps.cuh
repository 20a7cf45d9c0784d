// The bf16 tap gradients of the up conv (kernel d) and of the decoder chain's
// pair conv (kernel n's dtaps) on the tensor cores: the upsampled operand is
// built once into device memory by a pass over the level-s grid, then one
// GEMM gathers its rows through the conv table.
//
// Replaces, in bf16: geniconet_tpu/ops/pallas/phase_kernel.py:_upd_bwd's
// dtaps call (:2150, _up_dtaps_kernel) and _updp_bwd's dtaps call (:2490,
// _up_pair_dtaps_kernel). The float32 path keeps gn::dtaps_gemm over
// gn::UpLoad (backward.cuh), the SIMT core, bit for bit.
//
// What bounds it on the card. dtaps[t][k][n] = sum_q U[row_t(q)][k] G(q, n)
// over q = (sample, phase slot, cell), B * 4 * 5hw rows: 42-85 GFLOP a site
// at B=36, bound by the tensor cores' bf16 rate (0.04-0.09 ms at 989
// TFLOP/s). The SIMT kernel rebuilt every upsampled cell on every load
// (a conv-table read, two midpoint-table reads, one or two cells, a 5-cell
// mean at a pole; for n each cell also the pair join), once for each of the
// 7 taps and each column tile, and reached 5-6 TFLOP/s. This design's GEMM
// reaches 230-270 TFLOP/s on an H100 without the fold and 140-165 with it
// (PERF.md §6): not the tensor cores' rate but the instructions of each
// 32-row step (copies and their addresses, a barrier, the fold's ALU and
// shared-memory traffic) over 16 warps an SM. wgmma (asynchronous, a
// producer warp for the copies) is the way on; two taps a block, which
// halves what a block reads from L2 for g and y, ran slower at one block
// an SM.
//
// Design.
// 1. up_operand_pass writes the upsampled level-(s+1) operand once, in the
//    activation dtype (for n, after pair_join_pass has joined the pair once
//    into a level-s grid): per sample the 4 * 5hw cells of the four phases,
//    then the level-(s+1) north and south pole rows (the phase pad's poles: the
//    5-chart means, or zeros under corner_mode "zeros"), and after the last
//    sample one zero row; channels padded with zeros to a multiple of 8, so
//    every row is 16-byte aligned. Every value is what gn::UpLoad loads (the
//    same ucell / pcell / pole arithmetic and roundings), through GridCells
//    (d) or PairCells (n: the join of b0 and y10 by split_row, each level-s
//    cell joined once). Bound by the bytes it writes (12-94 MB a site at
//    B=36).
// 2. mma_dtaps: a block takes one tap t, 128 channels k and 128 columns n,
//    over a chunk of q in steps of 32 rows. A (the gathered operand rows,
//    [q][k]) and G (the cotangent rows, [q][n]; with the fold also y) come
//    into a 4-stage shared-memory ring by cp.async of 16 bytes, zero-filled
//    past the edges; a conv-table code names an operand row (a cell, the
//    sample's pole row, or the zero row) by selects, the codes fetched one
//    stage ahead. With the fold each thread folds, in place, the g chunks it
//    copied itself: g + gs0 + 2 * gs1 * y with GLoad's roundings (fold_geff),
//    one step ahead of the MMAs and between them, so that its ALU work
//    overlaps the tensor cores' (the fold in the B fragments' registers
//    instead, done by both warps that read a fragment, ran slower). Each
//    thread copies one row's two chunks of A and of G.
//    Both tiles are MN-major for a product that reduces over q, so the
//    fragments come by ldmatrix.trans, and mma.sync.m16n8k16 (bf16 products,
//    float32 sums) multiplies them: 8 warps, 64 x 32 a warp. wgmma would
//    read the same tiles from shared memory with its transpose bits, but
//    needs them in its core-matrix layout (and a descriptor per stage);
//    mma.sync over padded rows (136 elements, conflict-free ldmatrix) is the
//    simpler landing. The grid runs the 7 taps and the k tiles of one
//    chunk together (blockIdx.x fastest), so a chunk's g and y rows come
//    from device memory about once and from L2 the other times.
// 3. Cross-block sums as before: float32 partials per chunk, then a
//    fixed-order sum (sum_chunks: one thread a column, as the chunks are
//    few), so results repeat exactly; d and n run the same GEMM on
//    bit-equal operands with the same split, so their dtaps are bit-equal
//    on the joined grid.
#pragma once

#include "backward.cuh"

namespace gn {

// the operand rows' layout, shared by the pass and the GEMM's loader
__host__ __device__ __forceinline__ int operand_width(int cin) { return (cin + 7) & ~7; }
__host__ __device__ __forceinline__ int operand_per_sample(int hw5) { return 4 * hw5 + 2; }

// The operand pass's loads 8 channels at a time, where C_in is a multiple
// of 8 (16-byte rows): gn::UpLoad's pcell / ucell / pole arithmetic, value
// by value in its order and roundings, on the 8 channels of a Cells8.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  alignas(16) T t[8];
#pragma unroll
  for (int j = 0; j < (int)sizeof(t) / 16; ++j)
    reinterpret_cast<uint4*>(t)[j] = reinterpret_cast<const uint4*>(p)[j];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = to_f(t[e]);
}

// 8 channels k0 .. k0 + 7 of the level-s cells: a GridCells row as it is;
// a PairCells cell joined, with its 4 affines' 8 channels loaded once.
template <typename Cells>
struct Cells8;

template <typename T>
struct Cells8<GridCells<T>> {
  const T* x;
  int k0, hw5, cin;
  __device__ __forceinline__ Cells8(const GridCells<T>& c, int k0_, int hw5_, int cin_)
      : x(c.x), k0(k0_), hw5(hw5_), cin(cin_) {}
  __device__ __forceinline__ void operator()(int b, int r, float (&v)[8]) const {
    load8(x + ((size_t)b * hw5 + r) * cin + k0, v);
  }
};

template <typename T>
struct Cells8<PairCells<T>> {
  const PairCells<T>& x;
  int k0, cin;
  float aff[4][8];
  __device__ __forceinline__ Cells8(const PairCells<T>& c, int k0_, int, int cin_)
      : x(c), k0(k0_), cin(cin_) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) aff[i][e] = c.aff[i][k0 + e];
  }
  __device__ __forceinline__ void operator()(int b, int r, float (&v)[8]) const {
    size_t row;
    const int p = split_row(b, r, x.lh, x.lw, row);
    float a[8], c[8];
    load8(pick4(x.b0, p) + row * cin + k0, a);
    load8(pick4(x.y10, p) + row * cin + k0, c);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = round_to<T>(fmaxf(pair_pre(a[e], c[e], aff[0][e], aff[1][e], aff[2][e], aff[3][e]),
                               0.f));
  }
};

template <typename T, typename Cells>
__device__ __forceinline__ void pcell8(const UpLoad<T, Cells>& ld, const Cells8<Cells>& x, int b,
                                       int code, float (&v)[8]) {
  if (code >= 0) {
    x(b, code, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  if (code == ZERO) return;
  const int off = code == NORTH ? 0 : ld.hw - 1;
  for (int c = 0; c < 5; ++c) {
    float t[8];
    x(b, c * ld.hw + off, t);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += t[e];
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = round_to<T>(v[e] * 0.2f);
}

template <typename T, typename Cells>
__device__ __forceinline__ void ucell8(const UpLoad<T, Cells>& ld, const Cells8<Cells>& x, int b,
                                       int idx, float (&v)[8]) {
  pcell8(ld, x, b, ld.up[2 * idx], v);
  const int second = ld.up[2 * idx + 1];
  if (second == NONE) return;
  float t[8];
  pcell8(ld, x, b, second, t);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = round_to<T>(round_to<T>(v[e] + t[e]) * 0.5f);
}

// Whether every level-s tensor of the cells is 16-byte aligned (with C_in a
// multiple of 8, every row then is, for the 8-channel loads).
inline bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }
template <typename T>
bool aligned16(const GridCells<T>& c) { return aligned16(c.x); }
template <typename T>
bool aligned16(const PairCells<T>& c) {
  for (int p = 0; p < 4; ++p)
    if (!aligned16(c.b0[p]) || !aligned16(c.y10[p])) return false;
  return true;
}

// One thread: one operand row, 8 channels, of a level-s grid (for n, the
// pair joined by pair_join_pass; Tag names the instantiation: GridCells for
// d, PairCells for n). vec: C_in is a multiple of 8 and the grid's rows are
// 16-byte aligned, so loads take 8 channels at a time.
template <typename T, typename Tag>
__global__ void __launch_bounds__(256)
up_operand_pass(UpLoad<T> ld, T* __restrict__ out, int B, int zero_poles, int vec,
                long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ldk = operand_width(ld.cin), chunks = ldk / 8;
  const long long r = i / chunks;
  const int c = (int)(i - r * chunks);
  const int per = operand_per_sample(ld.hw5);
  const int b = (int)(r / per), rr = (int)(r - (long long)b * per);
  const int phases = 4 * ld.hw5;
  const bool pole = rr >= phases, cell = b < B && !(pole && zero_poles);
  float v[8];
  if (vec) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
    const Cells8<GridCells<T>> x(ld.x, c * 8, ld.hw5, ld.cin);
    if (cell && !pole) {
      ucell8(ld, x, b, rr, v);
    } else if (cell) {  // level-(s+1) pole: 5-chart mean of phase ee cell 0 / phase oq cell hw-1
      const int base = rr == phases ? 0 : 3 * ld.hw5 + ld.hw - 1;
      for (int ch = 0; ch < 5; ++ch) {
        float t[8];
        ucell8(ld, x, b, base + ch * ld.hw, t);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += t[e];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = round_to<T>(v[e] * 0.2f);
    }
  } else {  // a ragged C_in (or rows): channel by channel through UpLoad itself
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = c * 8 + e;
      v[e] = !cell || k >= ld.cin ? 0.f
             : pole ? ld(b, rr == phases ? NORTH : SOUTH, k) : ld.ucell(b, rr, k);
    }
  }
  alignas(16) T pack[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) pack[e] = from_f<T>(v[e]);
  uint4* dst = reinterpret_cast<uint4*>(out + r * ldk + c * 8);
#pragma unroll
  for (int j = 0; j < (int)sizeof(pack) / 16; ++j) dst[j] = reinterpret_cast<const uint4*>(pack)[j];
}

// One thread: 8 channels of one cell of the level-s grid that a pair joins
// into, written as a (B, 5, h, w, C_in) grid: PairCells' join, value by value.
template <typename T>
__global__ void __launch_bounds__(256)
pair_join_pass(PairCells<T> x, T* __restrict__ out, int hw5, int cin, int vec, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int chunks = (cin + 7) / 8;
  const long long r = i / chunks;
  const int c = (int)(i - r * chunks);
  const int b = (int)(r / hw5), cell = (int)(r - (long long)b * hw5);
  T* dst = out + r * cin + c * 8;
  if (vec) {
    float v[8];
    Cells8<PairCells<T>>(x, c * 8, hw5, cin)(b, cell, v);
    alignas(16) T pack[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) pack[e] = from_f<T>(v[e]);
#pragma unroll
    for (int j = 0; j < (int)sizeof(pack) / 16; ++j)
      reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(pack)[j];
  } else {
    for (int e = 0; e < 8 && c * 8 + e < cin; ++e)
      dst[e] = from_f<T>(x(b, cell, c * 8 + e, hw5, cin));
  }
}

// Write the (B * (4 * 5hw + 2) + 1, operand_width(cin)) operand of a level-s
// grid; Tag names the pass (GridCells: d's, PairCells: n's).
template <typename T, typename Tag>
cudaError_t launch_grid_operand(const UpLoad<T>& ld, T* out, int B, int zero_poles,
                                cudaStream_t stream) {
  const long long rows = (long long)B * operand_per_sample(ld.hw5) + 1;
  const long long total = rows * (operand_width(ld.cin) / 8);
  const int vec = ld.cin % 8 == 0 && aligned16(ld.x);
  up_operand_pass<T, Tag><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      ld, out, B, zero_poles, vec, total);
  return cudaGetLastError();
}

// The operand of the up conv's level-s grid (d; `joined` is not used) ...
template <typename T>
cudaError_t launch_up_operand(const UpLoad<T>& ld, T* out, void*, int B, int zero_poles,
                              cudaStream_t stream) {
  return launch_grid_operand<T, GridCells<T>>(ld, out, B, zero_poles, stream);
}

// ... or of a pair (n): the pair joined once into `joined`, (B, 5, h, w,
// C_in), then the same pass over that grid.
template <typename T>
cudaError_t launch_up_operand(const UpLoad<T, PairCells<T>>& ld, T* out, T* joined, int B,
                              int zero_poles, cudaStream_t stream) {
  if (joined == nullptr) return cudaErrorInvalidValue;
  const long long total = (long long)B * ld.hw5 * ((ld.cin + 7) / 8);
  const int vec = ld.cin % 8 == 0 && aligned16(ld.x);
  pair_join_pass<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(ld.x, joined, ld.hw5,
                                                                         ld.cin, vec, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  UpLoad<T> grid;
  grid.x = {joined};
  grid.up = ld.up;
  grid.hw = ld.hw;
  grid.hw5 = ld.hw5;
  grid.cin = ld.cin;
  return launch_grid_operand<T, PairCells<T>>(grid, out, B, zero_poles, stream);
}

// The A loader of mma_dtaps: rows of a built operand named by the conv
// table of output phase slot, tap t and cell m.
struct OperandRows {
  const __nv_bfloat16* rows;
  const int* table;  // (4, 7, M) halo.phase_conv_table
  int M, ldk, per_b, zero_row;

  __device__ __forceinline__ int code(int slot, int t, int m) const {
    return __ldg(&table[(slot * 7 + t) * M + m]);
  }
  // a cell, the sample's pole rows after its 4M cells, or the zero row
  __device__ __forceinline__ const __nv_bfloat16* row(int b, int code) const {
    const long long base = (long long)b * per_b;
    const long long r = code >= 0 ? base + code
                        : code == ZERO ? (long long)zero_row
                        : base + 4 * M + (code == NORTH ? 0 : 1);
    return rows + r * ldk;
  }
};

namespace mma {

constexpr int BM = 128;          // channels k of one tap a block
constexpr int BN = 128;          // columns n a block
constexpr int BK = 32;           // rows q a stage
constexpr int STAGES = 4;
constexpr int NT = 256;
constexpr int LDS = 136;         // a tile row in bf16: 128 + 8 keeps ldmatrix conflict-free
constexpr int TILE = BK * LDS;   // bf16 elements of one tile

__host__ __device__ constexpr int smem_bytes(bool fold) {
  return STAGES * (fold ? 3 : 2) * TILE * 2 + (fold ? 2 * BN * 4 : 0);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8x8 b16 matrices, transposed: lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where the fold's constant of block column col (0..BN-1) lies in shared
// memory: column col = (lc + 8c) * 8 + 4q + i sits at ((2c + q) * 8 + lc) * 4
// + i, so that the 8 chunks lc of a warp's float4 reads are 8 consecutive
// vectors (conflict-free).
__host__ __device__ constexpr int gsm_at(int col) {
  return ((((col >> 6) * 2 + ((col >> 2) & 1)) * 8 + ((col >> 3) & 7)) << 2) + (col & 3);
}

// Where a load row stands: q = b * 4M + slot * M + m.
struct RowPos {
  int q, b, slot, m;
  __device__ __forceinline__ void start(int q0, int M) {
    q = q0;
    b = q0 / (4 * M);
    const int r = q0 - b * 4 * M;
    slot = r / M;
    m = r - slot * M;
  }
  __device__ __forceinline__ void advance(int M) {
    q += BK;
    m += BK;
    while (m >= M) {
      m -= M;
      if (++slot == 4) {
        slot = 0;
        ++b;
      }
    }
  }
};

}  // namespace mma

// dtaps partials on the tensor cores: ws[chunk][t * cin + k][n] = sum over the
// chunk's rows q of U[row_t(q)][k] * G(q, n). Block (t + 7 * k tile, n tile,
// chunk). Tag (GridCells or PairCells) only names the instantiation, so a
// profile tells d's launches from n's; the code is one.
template <typename Tag, bool FOLD>
__global__ void __launch_bounds__(mma::NT, 2)
mma_dtaps(OperandRows ld, GLoad<__nv_bfloat16> gl, int cin, int n_sets, int Q, int kc,
          int g_vec, float* __restrict__ ws) {
  using bf16 = __nv_bfloat16;
  // the tile's constants (gn:: has the SIMT core's BM, BN, BK)
  constexpr int BM = mma::BM, BN = mma::BN, BK = mma::BK, STAGES = mma::STAGES;
  constexpr int LDS = mma::LDS, TILE = mma::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int stage_elems = (FOLD ? 3 : 2) * TILE;
  float* gsm = reinterpret_cast<float*>(smem + STAGES * stage_elems);  // FOLD: [2][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x % 7, k0 = (blockIdx.x / 7) * BM;
  const int n0 = blockIdx.y * BN, chunk = blockIdx.z;
  const int q_lo = chunk * kc, q_hi = min(q_lo + kc, Q);
  const int steps = (q_hi - q_lo + BK - 1) / BK;
  const int M = gl.M, cout = gl.cout, Ntot = n_sets * cout;

  if constexpr (FOLD) {  // the block's columns' gs0, gs1 (gsm_at: as the fold reads them)
    if (tid < BN) {
      const int n = n0 + tid;
      float s0 = 0.f, s1 = 0.f;
      if (n < Ntot) {
        const int s = n / cout, nl = n - s * cout;
        s0 = gl.gs[s][nl];
        s1 = gl.gs[s][cout + nl];
      }
      const int at = mma::gsm_at(tid);
      gsm[at] = s0;
      gsm[BN + at] = s1;
    }
    __syncthreads();
  }

  // load roles: row lr of each stage, its 8-element chunks lc and lc + 8 of A
  // and of G (and y), so that one row's position, code and addresses serve 4
  // (6) copies
  const int lr = tid >> 3, lc = tid & 7;
  int a_bytes[2], g_set[2], g_nl[2];
  bool g_ok[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    a_bytes[c] = k0 + (lc + 8 * c) * 8 < ld.ldk ? 16 : 0;
    const int gn = n0 + (lc + 8 * c) * 8;
    g_ok[c] = gn < Ntot;
    g_set[c] = g_ok[c] ? gn / cout : 0;
    g_nl[c] = gn - g_set[c] * cout;
  }

  mma::RowPos pos;
  pos.start(q_lo + lr, M);
  int code = ld.code(pos.slot, t, pos.m);

  auto copy_step = [&](int buf) {
    bf16* As = smem + buf * stage_elems;
    bf16* Gs = As + TILE;
    const bool ok = pos.q < q_hi;
    const bf16* arow = ld.row(pos.b, code) + k0;
    const size_t cell = (size_t)pos.b * M + pos.m;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int so = lr * LDS + (lc + 8 * c) * 8;
      const bool va = ok && a_bytes[c];
      mma::cp_async16(As + so, va ? arow + (lc + 8 * c) * 8 : ld.rows, va ? 16 : 0);
      if (g_vec) {
        const int gi = g_set[c] * 4 + pos.slot;
        const bool v = ok && g_ok[c];
        const size_t off = cell * cout + g_nl[c];
        mma::cp_async16(Gs + so, v ? gl.g[gi] + off : gl.g[0], v ? 16 : 0);
        if constexpr (FOLD)
          mma::cp_async16(Gs + TILE + so, v ? gl.y[gi] + off : gl.y[0], v ? 16 : 0);
      } else {  // a ragged cout (or unaligned g): element by element, into the same slots
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = n0 + (lc + 8 * c) * 8 + e;
          bf16 gv = from_f<bf16>(0.f), yv = gv;
          if (ok && n < Ntot) {
            const int s = n / cout, nl = n - s * cout;
            const size_t off = cell * cout + nl;
            gv = gl.g[s * 4 + pos.slot][off];
            if constexpr (FOLD) yv = gl.y[s * 4 + pos.slot][off];
          }
          Gs[so + e] = gv;
          if constexpr (FOLD) Gs[TILE + so + e] = yv;
        }
      }
    }
  };
  auto next_row = [&]() {
    pos.advance(M);
    code = ld.code(pos.slot, t, pos.m);  // used by the next copy_step
  };

  // fold the g chunk lc + 8c this thread copied of step j, in place (FOLD)
  auto fold_chunk = [&](int j, int c) {
    bf16* Gs = smem + (j % STAGES) * stage_elems + TILE;
    const int col = (lc + 8 * c) * 8, so = lr * LDS + col;
    alignas(16) bf16 gv[8], yv[8];
    *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(Gs + so);
    *reinterpret_cast<uint4*>(yv) = *reinterpret_cast<const uint4*>(Gs + TILE + so);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 s0 = reinterpret_cast<const float4*>(gsm)[mma::gsm_at(col + 4 * q) / 4];
      const float4 s1 = reinterpret_cast<const float4*>(gsm + BN)[mma::gsm_at(col + 4 * q) / 4];
      const float a0[4] = {s0.x, s0.y, s0.z, s0.w}, a1[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gv[4 * q + e] = from_f<bf16>(fold_geff<bf16>(to_f(gv[4 * q + e]), to_f(yv[4 * q + e]),
                                                     a0[e], a1[e]));
    }
    *reinterpret_cast<uint4*>(Gs + so) = *reinterpret_cast<const uint4*>(gv);
  };

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < steps) {
      copy_step(j);
      next_row();
    }
    mma::cp_async_commit();
  }
  if constexpr (FOLD) {  // step 0; later steps fold one step ahead, between the MMAs
    mma::cp_async_wait<STAGES - 2>();
    fold_chunk(0, 0);
    fold_chunk(0, 1);
  }

  // warp tile: channels wm * 64 .. +63, columns wn * 32 .. +31
  const int wm = warp & 1, wn = warp >> 1;
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  // ldmatrix row addresses (elements) within a tile, before the k16 offset
  const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * LDS + wm * 64 + ((lane >> 3) & 1) * 8;
  const int b_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDS + wn * 32 + (lane >> 4) * 8;

  for (int i = 0; i < steps; ++i) {
    // this thread's copies of step i (FOLD: of step i + 1, which it folds below) have landed
    if constexpr (FOLD) mma::cp_async_wait<STAGES - 3>();
    else mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step i (folded) visible to all; every warp is done with step i - 1
    if (i + STAGES - 1 < steps) {
      copy_step((i + STAGES - 1) % STAGES);
      next_row();
    }
    mma::cp_async_commit();
    const bf16* As = smem + (i % STAGES) * stage_elems;
    const bf16* Gs = As + TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned b[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        unsigned r[4];
        mma::ldsm_x4_trans(r, Gs + b_off + kk * LDS + nj * 16);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        unsigned a[4];
        mma::ldsm_x4_trans(a, As + a_off + kk * LDS + mi * 16);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma::mma_bf16(acc[mi][ni], a, b[ni][0], b[ni][1]);
      }
      // the next step's fold, one chunk a k16 step, while the tensor cores work
      if constexpr (FOLD)
        if (i + 1 < steps) fold_chunk(i + 1, kk / 16);
    }
  }
  mma::cp_async_wait<0>();

  // acc[mi][ni]: channels wm*64 + mi*16 + lane/4 (+8 for e >= 2), columns
  // wn*32 + ni*8 + 2*(lane%4) (+1 for odd e)
  const int Mr = 7 * cin;
  float* part = ws + (size_t)chunk * Mr * Ntot;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + wm * 64 + mi * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
      if (k >= cin) continue;
      float* prow = part + (size_t)(t * cin + k) * Ntot;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * (lane & 3) + (e & 1);
        if (n < Ntot) prow[n] = acc[mi][ni][e];
      }
    }
}

// The fixed-order sum of mma_dtaps' chunk partials: out(c) = in[0][c] +
// in[1][c] + ... in row order, one thread a column (few chunks: for R <= 32
// the sums gn::sum_rows makes, without its 32 row lanes a column).
template <typename Store>
__global__ void __launch_bounds__(256)
sum_chunks(const float* __restrict__ in, int R, long long C, Store st) {
  const long long c = (long long)blockIdx.x * 256 + threadIdx.x;
  if (c >= C) return;
  float acc = 0.f;
  for (int r = 0; r < R; ++r) acc += in[(size_t)r * C + c];
  st(c, acc);
}

template <typename Tag, bool FOLD>
cudaError_t mma_dtaps_attr() {
  return cudaFuncSetAttribute(mma_dtaps<Tag, FOLD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              mma::smem_bytes(FOLD));
}

// bf16 dtaps[set] (7, cin, cout) float32: the operand pass into `operand`
// ((B * (4 * 5hw + 2) + 1, operand_width(cin)) bf16), the GEMM into ws
// (n_chunks, 7 * cin, n_sets * cout) over Q = B * 4 * 5hw rows in chunks of
// kc (a multiple of mma::BK), then the fixed-order sum of the partials
// (sum_chunks).
template <typename Cells>
cudaError_t launch_mma_dtaps(const UpLoad<__nv_bfloat16, Cells>& up,
                             const GLoad<__nv_bfloat16>& gl, const int* conv_table,
                             __nv_bfloat16* operand, __nv_bfloat16* joined, int zero_poles, int B,
                             int cin, int n_sets, int kc, int n_chunks, float* ws, float* dt0,
                             float* dt1, cudaStream_t stream) {
  if (kc % mma::BK != 0 || operand == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = launch_up_operand(up, operand, joined, B, zero_poles, stream);
  if (err != cudaSuccess) return err;
  const int M = gl.M, Ntot = n_sets * gl.cout;
  OperandRows ld;
  ld.rows = operand;
  ld.table = conv_table;
  ld.M = M;
  ld.ldk = operand_width(cin);
  ld.per_b = operand_per_sample(M);
  ld.zero_row = B * ld.per_b;
  const int Q = B * 4 * M;
  dim3 grid(7 * ((cin + mma::BM - 1) / mma::BM), (Ntot + mma::BN - 1) / mma::BN, n_chunks);
  const bool fold = gl.gs[0] != nullptr;
  // 16-byte copies of g (and y) rows: cout a multiple of 8, the tensors aligned
  int g_vec = gl.cout % 8 == 0;
  for (int i = 0; i < 4 * n_sets; ++i)
    g_vec = g_vec && aligned16(gl.g[i]) && (!fold || aligned16(gl.y[i]));
  if (fold) {
    if ((err = mma_dtaps_attr<Cells, true>()) != cudaSuccess) return err;
    mma_dtaps<Cells, true><<<grid, mma::NT, mma::smem_bytes(true), stream>>>(ld, gl, cin, n_sets,
                                                                             Q, kc, g_vec, ws);
  } else {
    if ((err = mma_dtaps_attr<Cells, false>()) != cudaSuccess) return err;
    mma_dtaps<Cells, false><<<grid, mma::NT, mma::smem_bytes(false), stream>>>(
        ld, gl, cin, n_sets, Q, kc, g_vec, ws);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const SplitOut st = {{dt0, dt1}, Ntot, gl.cout};
  const long long C = 7LL * cin * Ntot;
  sum_chunks<SplitOut><<<(unsigned)((C + 255) / 256), 256, 0, stream>>>(ws, n_chunks, C, st);
  return cudaGetLastError();
}

// Registers a thread, blocks an SM and dynamic shared memory of one
// instantiation (for the records).
template <typename Tag, bool FOLD>
cudaError_t mma_dtaps_info(int* out) {
  cudaError_t err = mma_dtaps_attr<Tag, FOLD>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, mma_dtaps<Tag, FOLD>)) != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mma_dtaps<Tag, FOLD>, mma::NT,
                                                      mma::smem_bytes(FOLD));
  out[0] = attr.numRegs;
  out[1] = blocks;
  out[2] = mma::smem_bytes(FOLD);
  out[3] = (int)attr.localSizeBytes;
  return err;
}

}  // namespace gn
