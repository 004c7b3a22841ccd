// The wide form of the I2C filter and smoother (kernels 8a/8b): any D and Z
// from past kGeneralMax up to kWideMax (ops/i2c_smooth.py: kernel_form).
// Included by i2c_smooth.cu inside its anonymous namespace, after
// i2c_general.cuh, whose helpers it uses (load_row, store_row, own_stride,
// kFullMask) beside floor_keep_nan, div_rn and the cp.async helpers.
//
// What held the large form (a warp a scenario, each entry of each product
// one lane's serial dot product with both factors loaded from memory and F
// and J read from device memory inside it, an integer division per entry
// index, a __syncwarp per Cholesky column, shared memory growing with D^2)
// at about 34x its bytes bound at D = Z = 16, and what this form does:
// - A warp per scenario, a block per warp (kWideWarps). Lane r owns row r of
//   every product it forms: of P J^T, the gain, sf, sig_f, F sig_f and
//   sig_pred in the filter (row r of sig_y: lane r < Z), of M = F sig_f, G,
//   G Dlt and sig_next in the smoother. The row being formed is the only
//   matrix row in registers, N = 20, 24, 28 or 32 entries (the smallest
//   that holds max(D, Z)); finished rows go to shared memory. Lanes past D
//   (or Z) compute a copy of row D - 1 (Z - 1), write the same values to the
//   same shared addresses and store nothing to device memory.
// - Every product a[j] = sum over k of x[k] Y[k][j] runs a loop over k that
//   stops at the runtime D or Z: x[k], this lane's own entry, is one 4-byte
//   load from a matrix kept by columns (the lanes' addresses consecutive),
//   and Y's row k is read four floats a load at the same address for every
//   lane. So each matrix is kept in the layout its next use reads: by rows
//   (stride own_stride(N)) where it is a Y, by columns where it is an x.
//   The loops over a sum's index unroll by two, so a step's code stays a
//   few thousand bytes, and no loop divides integers.
// - The Cholesky factorisation of sig_y (the smoother's sig_pred) and the
//   forward solve of each lane's own right-hand side run in one loop over
//   the columns (wide_chol_forward): the two rows in registers, the
//   diagonal and the next row's L by shuffles, the column of L through
//   shared memory (L^T by rows), each column's chain a square root, two
//   shuffles, a division and one multiply-subtract. The backward solve runs
//   by rows of L^T with the solution in the lane's own column of shared
//   memory, each row's divisor and first factor loaded a row ahead.
// - One staging slot, copied by 4-byte cp.async a row at a time (lane k
//   takes entry k of each row: coalesced reads), each part refilled as soon
//   as the step's last read of it is behind the warp: the filter's J after
//   the gain, its F at the step's end; the smoother's sig_f and F once M is
//   formed (the own row of sig_f stays in registers for sig_next), its
//   sig_pred once factored. Outputs go to device memory a row at a time
//   through shared memory (coalesced); the filter adds Q on that pass.
// Every entry is one lane's sum in the plain version's order, with its
// operations, so this form keeps the plain version's bits at every size.
// Warps past B return at once: no barrier spans warps.

constexpr int kWideMax = 32;   // the largest D and Z of this form
constexpr int kWideWarps = 1;  // warps (scenarios) per block

// Blocks an SM should hold at rows of N (its shared memory allows about as
// many), which caps a thread's registers. At rows of 20 the registers hold
// it to 16 (4 warps a scheduler); 20 blocks (96 registers) measured no
// faster, and spilled in the filter.
__host__ __device__ constexpr int wide_min_blocks(int N) {
  return N <= 20 ? 16 : N <= 24 ? 12 : N <= 28 ? 10 : 8;
}

template <int N>
struct WideFilterLayout {
  static constexpr int kRow = own_stride(N), kMat = N * kRow, kPSt = N + 1;
  // J^T staged (by columns of J: row k holds J[.][k]), then the gain by
  // columns; F^T staged; P J^T by rows, then sf by rows, then F sig_f by
  // columns; L^T by rows, then sig_f by rows; P J^T by columns; sig_p by
  // columns (stride N + 1: its rows are also read across lanes, where Q is
  // added on the coalesced store); mu_p, mu_f and the innovation
  static constexpr int kJT = 0, kFT = kMat, kA = 2 * kMat, kB = 3 * kMat, kPJT = 4 * kMat,
                       kPT = 5 * kMat, kMP = kPT + N * kPSt, kMF = kMP + N, kIN = kMF + N,
                       kScenFloats = kIN + N;
  static constexpr int kThreads = 32 * kWideWarps, kScen = kWideWarps, kChunk = 1;
  static constexpr int kBytes = kScen * kScenFloats * (int)sizeof(float);
};

template <int N>
struct WideRtsLayout {
  static constexpr int kRow = own_stride(N), kMat = N * kRow;
  // the slot: sig_f, sig_pred by rows, F^T; the carried sig_next by rows
  // (sig_next - sig_pred once the step has read sig_next); M by rows, then
  // G Dlt by columns; L^T and G^T (G by columns) by rows of N; the carried
  // mu_next
  static constexpr int kSF = 0, kSP = kMat, kFT = 2 * kMat, kSN = 3 * kMat, kA = 4 * kMat,
                       kLT = 5 * kMat, kGT = kLT + N * N, kMN = kGT + N * N,
                       kScenFloats = kMN + N;
  static constexpr int kThreads = 32 * kWideWarps, kScen = kWideWarps, kChunk = 1;
  static constexpr int kBytes = kScen * kScenFloats * (int)sizeof(float);
};

// rows x cols of a row-major slab into dst by columns (dst[c * S + r] =
// src[r][c]); lane c copies column c
template <int S>
__device__ __forceinline__ void wide_stage_cols(float* dst, const float* src, int rows,
                                                int cols, int lane) {
  if (lane < cols) {
#pragma unroll 4
    for (int i = 0; i < rows; ++i) cp_async4(dst + lane * S + i, src + i * cols + lane);
  }
}

// rows x cols of a row-major slab into dst by rows (stride S)
template <int S>
__device__ __forceinline__ void wide_stage_rows(float* dst, const float* src, int rows,
                                                int cols, int lane) {
  if (lane < cols) {
#pragma unroll 4
    for (int i = 0; i < rows; ++i) cp_async4(dst + i * S + lane, src + i * cols + lane);
  }
}

// a[0..N) = 0 + sum over k < n of x[k * XS] * Y[k * YS + 0..N), each entry's
// sum in the order of k: x this lane's column, Y's rows four floats a load.
template <int N, int XS, int YS>
__device__ __forceinline__ void wide_times(float (&a)[N], const float* x, const float* Y, int n) {
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < n; ++k) {
    const float xk = x[k * XS];
    float v[N];
    load_row<N>(v, Y + k * YS);
#pragma unroll
    for (int j = 0; j < N; ++j) a[j] = a[j] + xk * v[j];
  }
}

// x where i == c, else y, as one select the compiler keeps: a run of
// compares of one runtime index against each entry of a register array
// would otherwise become an indexed load, the array moved to local memory.
__device__ __forceinline__ float select_eq(int i, int c, float x, float y) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\tselp.f32 %0, %3, %4, p;\n\t}"
      : "=f"(r)
      : "r"(i), "r"(c), "f"(x), "f"(y));
  return r;
}

// Whether i == c, in a form the compiler does not see through: branches on
// one runtime index against each constant would otherwise become a switch
// on an indexed array, moved to local memory.
__device__ __forceinline__ bool same_int(int i, int c) {
  int r;
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\tselp.s32 %0, 1, 0, p;\n\t}"
      : "=r"(r)
      : "r"(i), "r"(c));
  return r != 0;
}

// The lower Cholesky factor of the n x n matrix whose row r is this lane's
// a[] (entries past r unused), with the forward solve y = L^-1 b of this
// lane's right-hand side b[] beside it: column j of L goes to LT's row j
// (LT[j * N + r] = L[r][j]) and y to this lane's column Y[k * N]. Column j:
// lane j's diagonal by a shuffle, each lane's division, L[j + 1][j] from
// lane j + 1 by a second shuffle, y_j; entry j + 1 of a and b then takes its
// update at once (the chains from column to column), the rest take theirs
// from the column read back from
// LT, four floats a load, in the chunks of four that hold an entry past j;
// the chunk that holds entry j + 2 also hands it to the next column (by
// selects: no register is indexed at run time). Every entry's subtractions
// come in the order of j; entries already done (c <= j) and past n are not
// read again, so a chunk updates all four of its entries.
template <int N>
__device__ __forceinline__ void wide_chol_forward(float (&a)[N], int r, float (&b)[N], float* Y,
                                                  int n, float* LT) {
  float cur = a[0], curb = b[0], ahead = a[1], aheadb = b[1];
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const float d = __shfl_sync(kFullMask, sqrtf(floor_keep_nan(cur)), j);
    const float l = div_rn(cur, d);
    const float below = __shfl_sync(kFullMask, l, j + 1 < 32 ? j + 1 : j);  // L[j + 1][j]
    LT[j * N + r] = r == j ? d : l;
    cur = ahead - l * below;
    const float y = div_rn(curb, d);
    Y[j * N] = y;
    curb = aheadb - below * y;
    __syncwarp();
    const int j2 = j + 2;
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      if (4 * q + 3 > j && 4 * q < n) {
        const float4 l4 = reinterpret_cast<const float4*>(LT + j * N)[q];
        const float lc[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[4 * q + e] = a[4 * q + e] - l * lc[e];
          b[4 * q + e] = b[4 * q + e] - lc[e] * y;
        }
        if (same_int(j2 >> 2, q)) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ahead = select_eq(j2, 4 * q + e, a[4 * q + e], ahead);
            aheadb = select_eq(j2, 4 * q + e, b[4 * q + e], aheadb);
          }
        }
      }
    }
  }
}

// x = L^-T y, y in this lane's column X[k * N] (overwritten by x), by rows of
// L^T, each sum in the order of k; the next row's y, divisor and first
// factor are loaded a row ahead.
template <int N>
__device__ __forceinline__ void wide_backward(int n, const float* LT, float* X) {
  float last = 0.0f;  // x[i + 1], the one just formed
  float s_next = X[(n - 1) * N], diag = LT[(n - 1) * N + n - 1], first = 0.0f;
#pragma unroll 1
  for (int i = n - 1; i >= 0; --i) {
    const float* li = LT + i * N;  // L[k][i] at li[k]
    const int i0 = i > 0 ? i - 1 : 0;
    float s = s_next;
    const float diag_i = diag, first_i = first;
    s_next = X[i0 * N];
    diag = LT[i0 * N + i0];
    first = LT[i0 * N + i];
    if (i + 1 < n) {
      s = s - first_i * last;
#pragma unroll 4
      for (int k = i + 2; k < n; ++k) s = s - li[k] * X[k * N];
    }
    last = div_rn(s, diag_i);
    X[i * N] = last;
  }
}

template <int N>
__global__ void __launch_bounds__(32 * kWideWarps, wide_min_blocks(N))
i2c_filter_wide(const float* __restrict__ F, const float* __restrict__ m,
                const float* __restrict__ J, const float* __restrict__ z0,
                const float* __restrict__ R, int r_stride,
                const float* __restrict__ mu0, const float* __restrict__ sig0,
                const float* __restrict__ Qproc, const float* __restrict__ g_z,
                float* __restrict__ mu_f_out, float* __restrict__ sig_f_out,
                float* __restrict__ mu_pred_out, float* __restrict__ sig_pred_out,
                int B, int T, int D, int Z) {
  using L = WideFilterLayout<N>;
  constexpr int S = L::kRow, SP = L::kPSt;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWideWarps + w;
  if (b >= B) return;
  const int row = min(lane, D - 1), arow = min(lane, Z - 1);  // this lane's row of D, of Z
  float* sc = smem + w * L::kScenFloats;
  float *sJT = sc + L::kJT, *sGT = sc + L::kJT, *sFT = sc + L::kFT, *sA = sc + L::kA;
  float *sB = sc + L::kB, *sPJT = sc + L::kPJT, *sPT = sc + L::kPT;
  float *sMP = sc + L::kMP, *sMF = sc + L::kMF, *sIN = sc + L::kIN;
  const size_t bT = (size_t)b * T, DD = (size_t)D * D, ZD = (size_t)Z * D;

  wide_stage_cols<S>(sJT, J + bT * ZD, Z, D, lane);
  cp_async_commit();
  wide_stage_cols<S>(sFT, F + bT * DD, D, D, lane);
  cp_async_commit();
#pragma unroll 1
  for (int k = 0; k < D; ++k) sPT[k * SP + row] = sig0[row * D + k];
  float rr[N];  // own row of R, the same at every step
#pragma unroll
  for (int c = 0; c < N; ++c) rr[c] = c < Z ? R[(size_t)b * r_stride + arow * Z + c] : 0.0f;
  float mu_p = mu0[(size_t)b * D + row];
  sMP[row] = mu_p;

  for (int t = 0; t < T; ++t) {
    const size_t bt = bT + t;
    const float z0a = z0[bt * Z + arow], ga = g_z[(size_t)t * Z + arow], mi = m[bt * D + row];
    cp_async_wait<1>();
    __syncwarp();  // step t's J, and the carry
    // own row of P J^T, by rows and by columns; the innovation g - (J mu_p + z0)
    float acc[N];
    wide_times<N, SP, S>(acc, sPT + row, sJT, D);
    store_row<N>(sA + row * S, acc);
#pragma unroll
    for (int a = 0; a < N; ++a) sPJT[a * N + row] = acc[a];
    float s = 0.0f;
#pragma unroll 4
    for (int k = 0; k < D; ++k) s = s + sJT[k * S + arow] * sMP[k];
    const float innov = ga - (s + z0a);
    __syncwarp();  // P J^T
    // own row of sig_y = R + J P J^T, factored across the warp beside the
    // forward solve of the own gain row: sig_y x = (P J^T)[row]
    wide_times<N, S, S>(acc, sJT + arow, sA, D);
#pragma unroll
    for (int c = 0; c < N; ++c) acc[c] = rr[c] + acc[c];
    float rhs[N];
#pragma unroll
    for (int c = 0; c < N; ++c) rhs[c] = sPJT[c * N + row];
    wide_chol_forward<N>(acc, arow, rhs, sGT + row, Z, sB);
    sIN[arow] = innov;
    __syncwarp();  // L and the innovation; J and P J^T's rows are spent
    wide_backward<N>(Z, sB, sGT + row);
    // mu_f = mu_p + L innov; sf = sig_p - L (P J^T)^T, by rows into sA
    s = 0.0f;
#pragma unroll 4
    for (int a = 0; a < Z; ++a) s = s + sGT[a * N + row] * sIN[a];
    const float mf = mu_p + s;
    wide_times<N, N, N>(acc, sGT + row, sPJT, Z);
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = sPT[j * SP + row] - acc[j];
    store_row<N>(sA + row * S, acc);
    sMF[row] = mf;
    __syncwarp();  // sf and mu_f; every solve is done with L and the gain
    if (t + 1 < T) wide_stage_cols<S>(sJT, J + (bt + 1) * ZD, Z, D, lane);
    cp_async_commit();
    // sig_f = sym(sf), by rows into sB
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = 0.5f * (acc[j] + sA[j * S + row]);
    store_row<N>(sB + row * S, acc);
    if (lane < D) mu_f_out[bt * D + lane] = mf;
    cp_async_wait<1>();
    __syncwarp();  // sig_f, and step t's F
    if (lane < D) {
#pragma unroll 4
      for (int i = 0; i < D; ++i) sig_f_out[(bt * D + i) * D + lane] = sB[i * S + lane];
    }
    // predict: own entry of m + F mu_f, own row of F sig_f (by columns into
    // sA), then own row of (F sig_f) F^T (by columns into sPT; Q is added
    // where the rows are stored)
    wide_times<N, S, S>(acc, sFT + row, sB, D);
    s = 0.0f;
#pragma unroll 4
    for (int k = 0; k < D; ++k) s = s + sFT[k * S + row] * sMF[k];
    mu_p = mi + s;
#pragma unroll
    for (int k = 0; k < N; ++k) sA[k * N + row] = acc[k];
    sMP[row] = mu_p;
    if (lane < D) mu_pred_out[bt * D + lane] = mu_p;
    wide_times<N, N, S>(acc, sA + row, sFT, D);
#pragma unroll
    for (int j = 0; j < N; ++j) sPT[j * SP + row] = acc[j];
    __syncwarp();  // (F sig_f) F^T; F is spent
    if (t + 1 < T) wide_stage_cols<S>(sFT, F + (bt + 1) * DD, D, D, lane);
    cp_async_commit();
    if (lane < D) {
#pragma unroll 4
      for (int i = 0; i < D; ++i) {
        const float v = sPT[lane * SP + i] + Qproc[i * D + lane];
        sPT[lane * SP + i] = v;
        sig_pred_out[(bt * D + i) * D + lane] = v;
      }
    }
  }
}

// The smoother: step t's M and the own row of sig_f come first, so that
// sig_f's slot takes step t-1's at once; sig_pred's and F's wait for the
// factorisation. mu_pred is read from device memory where the mean needs it.
template <int N>
__global__ void __launch_bounds__(32 * kWideWarps, wide_min_blocks(N))
i2c_rts_wide(const float* __restrict__ mu_f, const float* __restrict__ sig_f,
             const float* __restrict__ mu_pred, const float* __restrict__ sig_pred,
             const float* __restrict__ F, float* __restrict__ mu_s, int B, int T, int D) {
  using L = WideRtsLayout<N>;
  constexpr int S = L::kRow;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWideWarps + w;
  if (b >= B) return;
  const int row = min(lane, D - 1);
  float* sc = smem + w * L::kScenFloats;
  float *sSF = sc + L::kSF, *sSP = sc + L::kSP, *sFT = sc + L::kFT, *sSN = sc + L::kSN;
  float *sA = sc + L::kA, *sLT = sc + L::kLT, *sGT = sc + L::kGT, *sMN = sc + L::kMN;
  const size_t bT = (size_t)b * T, DD = (size_t)D * D;

  // the carry starts from the filtered moments of t = T-1, the last output row
  if (lane < D) {
    const size_t bl = bT + T - 1;
#pragma unroll 1
    for (int i = 0; i < D; ++i) sSN[i * S + lane] = sig_f[(bl * D + i) * D + lane];
    const float mn = mu_f[bl * D + lane];
    sMN[lane] = mn;
    mu_s[bl * D + lane] = mn;
  }
  // step T-2's sig_f and F, then its sig_pred
  if (T > 1) {
    const size_t bt = bT + T - 2;
    wide_stage_rows<S>(sSF, sig_f + bt * DD, D, D, lane);
    wide_stage_cols<S>(sFT, F + bt * DD, D, D, lane);
  }
  cp_async_commit();
  if (T > 1) wide_stage_rows<S>(sSP, sig_pred + (bT + T - 2) * DD, D, D, lane);
  cp_async_commit();

  for (int t = T - 2; t >= 0; --t) {
    const size_t bt = bT + t;
    const float muf = mu_f[bt * D + row], mp = mu_pred[bt * D + row];
    cp_async_wait<0>();
    __syncwarp();  // step t's slot; the carry
    // own row of M = F sig_f; own row of sig_f, kept for sig_next; own row
    // of Dlt = sig_next - sig_pred in sig_next's place, and own entry of
    // mu_next - mu_pred in mu_next's
    float acc[N], sf[N];
    wide_times<N, S, S>(acc, sFT + row, sSF, D);
    store_row<N>(sA + row * S, acc);
    load_row<N>(sf, sSF + row * S);
    {
      float vn[N], vp[N];
      load_row<N>(vn, sSN + row * S);
      load_row<N>(vp, sSP + row * S);
#pragma unroll
      for (int j = 0; j < N; ++j) vn[j] = vn[j] - vp[j];
      if (lane < D) {
        store_row<N>(sSN + row * S, vn);
        sMN[lane] = sMN[lane] - mp;
      }
    }
    __syncwarp();  // M and Dlt; sig_f and F are spent
    if (t > 0) {
      wide_stage_rows<S>(sSF, sig_f + (bt - 1) * DD, D, D, lane);
      wide_stage_cols<S>(sFT, F + (bt - 1) * DD, D, D, lane);
    }
    cp_async_commit();
    // own row of sig_pred, factored across the warp beside the forward solve
    // of the own row of G: sig_pred x = M[:, row]
    float rhs[N];
#pragma unroll
    for (int c = 0; c < N; ++c) rhs[c] = sA[c * S + row];
    load_row<N>(acc, sSP + row * S);
    wide_chol_forward<N>(acc, row, rhs, sGT + row, D, sLT);
    __syncwarp();  // L; sig_pred is spent
    if (t > 0) wide_stage_rows<S>(sSP, sig_pred + (bt - 1) * DD, D, D, lane);
    cp_async_commit();
    wide_backward<N>(D, sLT, sGT + row);
    // the smoothed mean; own row of G Dlt, by columns over this lane's
    // column of M
    float s = 0.0f;
#pragma unroll 4
    for (int k = 0; k < D; ++k) s = s + sGT[k * N + row] * sMN[k];
    const float ms = muf + s;
    if (lane < D) mu_s[bt * D + lane] = ms;
    wide_times<N, N, S>(acc, sGT + row, sSN, D);
#pragma unroll
    for (int k = 0; k < N; ++k) sA[k * S + row] = acc[k];
    __syncwarp();  // G; every read of Dlt and mu_next is done
    // own row of sig_next = sig_f + G Dlt G^T, and the mean carried
    wide_times<N, S, N>(acc, sA + row, sGT, D);
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = sf[j] + acc[j];
    store_row<N>(sSN + row * S, acc);
    sMN[row] = ms;
  }
}
