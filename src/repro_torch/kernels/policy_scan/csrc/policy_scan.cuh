// Postfix predicate-program evaluation for one row, as a bit-stack.
//
// Every value on the reference's (max_stack, N) f32 stack is exactly 0 or 1:
// comparisons give 0/1, AND (a*b), OR (clip(a+b, 0, 1)) and NOT (1-a) keep
// it there, and the stack starts at zeros. So one uint32 register holds a
// row's whole 8-deep stack, bit k being slot k, and the machine below
// reproduces ref.eval_program bit for bit, clamp rules included:
//   - a and b are read at clamp(sp-1) and clamp(sp-2);
//   - the write position is clamped to [0, MAX_STACK-1];
//   - NOPs (op < 0) are skipped; an empty program gives 0.
// The stack pointer follows the opcodes alone, never the data, so a block
// decodes each program once (decode_program): NOPs dropped, and each
// instruction's read and write positions worked out ahead of the rows. The
// interpreter (eval_program) then only branches on the opcode, which is the
// same in every thread: its branches never diverge inside a warp.
//
// The staged column set of a launch (stage_plan) and the ring that holds it
// (ring_shape) are worked out here too. The functions are __host__
// __device__ so the staging plan, decoder and interpreter can be compiled
// for the host too.
#pragma once

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define PS_HD __host__ __device__ __forceinline__
#else
#define PS_HD inline
#endif

namespace policy_scan {

constexpr int MAX_STACK = 8;
constexpr int N_AGG = 14;      // count, volume, spc_used, hist x10, any_match
constexpr int N_BUCKETS = 10;
// A launch's table has at most MAX_COLS columns, so the ring below holds a
// stage of every column a launch can read: no column is ever read outside
// shared memory.
constexpr int MAX_COLS = 96;
constexpr int SEEN_WORDS = (MAX_COLS + 31) / 32;

constexpr int THREADS = 256;             // consumer threads a block
constexpr int ITEMS = 4;                 // rows a consumer thread a tile
constexpr int TILE = THREADS * ITEMS;
constexpr int RING_FLOATS = 26 * 1024;   // the stage ring, 104 KB
constexpr int MAX_STAGES = 4;

enum : int { OP_EQ = 0, OP_NE, OP_GT, OP_GE, OP_LT, OP_LE, OP_AND, OP_OR,
             OP_NOT, OP_ELSE };

PS_HD int clamp_slot(int pos) {
  return pos < 0 ? 0 : (pos > MAX_STACK - 1 ? MAX_STACK - 1 : pos);
}

// The column a live compare reads, clamped into [0, n_cols) as the
// reference clamps it; -1 for any other instruction (it reads none).
PS_HD int compare_col(int op, int col, int n_cols) {
  if (op < 0 || op >= 6) return -1;
  return col < 0 ? 0 : (col > n_cols - 1 ? n_cols - 1 : col);
}

// The staged columns of a launch from `seen`, the bit set of the columns
// its live compares read: size, blocks and valid (none when valid_col < 0),
// then the rest of `seen` in increasing order, each once. Returns their
// number (at most MAX_COLS).
PS_HD int stage_list(const uint32_t* seen, int size_col, int blocks_col,
                     int valid_col, int* stage) {
  int n = 0;
  stage[n++] = size_col;
  if (blocks_col != size_col) stage[n++] = blocks_col;
  if (valid_col >= 0 && valid_col != size_col && valid_col != blocks_col)
    stage[n++] = valid_col;
  for (int c = 0; c < MAX_COLS; ++c)
    if (((seen[c >> 5] >> (c & 31)) & 1u) && c != size_col &&
        c != blocks_col && c != valid_col)
      stage[n++] = c;
  return n;
}

// stage_list of programs (ops, colidx)[0:count], one thread alone (the
// kernel builds `seen` with all its threads, then calls stage_list).
PS_HD int stage_plan(const int* ops, const int* colidx, int count,
                     int n_cols, int size_col, int blocks_col, int valid_col,
                     int* stage) {
  uint32_t seen[SEEN_WORDS] = {};
  for (int i = 0; i < count; ++i) {
    const int c = compare_col(ops[i], colidx[i], n_cols);
    if (c >= 0) seen[c >> 5] |= 1u << (c & 31);
  }
  return stage_list(seen, size_col, blocks_col, valid_col, stage);
}

// How the ring holds n_stage columns: a stage is `items` rows a consumer
// thread (items * THREADS rows, a contiguous part of a tile), each column
// in a segment of `seg` floats (the rows and up to 3 floats before them,
// from the 16 B boundary), `stages` stages deep. The widest stage (a whole,
// half or quarter tile) that leaves 2 stages is taken, else a quarter tile
// with as many stages as fit (at least 1 for MAX_COLS columns). A thread
// meets its rows in the same order whatever the stage, so the sums do not
// depend on it.
struct Ring {
  int items, stages, seg;
};

PS_HD Ring ring_shape(int n_stage) {
  Ring g{ITEMS, 0, 0};
  for (;; g.items /= 2) {
    g.seg = g.items * THREADS + 4;
    g.stages = RING_FLOATS / (n_stage * g.seg);
    if (g.stages > MAX_STAGES) g.stages = MAX_STAGES;
    if (g.stages >= 2 || g.items == 1) return g;
  }
}

// A decoded instruction in one word: opcode (bits 0-3; OP_ELSE for any
// unknown opcode), read positions a (4-6) and b (7-9), write position
// (10-12) and, in bits 13-31, `where` a compare finds its column: the
// offset of the column's segment in a stage (`where_of` below).
PS_HD uint32_t pack(int op, int pa, int pb, int pw, int where) {
  return static_cast<uint32_t>(op) | static_cast<uint32_t>(pa) << 4 |
         static_cast<uint32_t>(pb) << 7 | static_cast<uint32_t>(pw) << 10 |
         static_cast<uint32_t>(where) << 13;
}

// Decodes program (ops, colidx, operands)[0:n_instr] into code/opr[0:len];
// a compare of (clamped) column c finds it at where_of[c]. Returns len;
// *final is the stack position of the result.
PS_HD int decode_program(const int* ops, const int* colidx,
                         const float* operands, int n_instr, int n_cols,
                         const int* where_of, uint32_t* code, float* opr,
                         int* final) {
  int sp = 0, len = 0;
  for (int i = 0; i < n_instr; ++i) {
    int op = ops[i];
    if (op < 0) continue;                                  // NOP
    const int pa = clamp_slot(sp - 1), pb = clamp_slot(sp - 2);
    int pw, where = 0;
    if (op < 6) {
      where = where_of[compare_col(op, colidx[i], n_cols)];
      pw = clamp_slot(sp);
      sp += 1;
    } else if (op == OP_AND || op == OP_OR) {
      pw = clamp_slot(sp - 2);
      sp -= 1;
    } else if (op == OP_NOT) {
      pw = clamp_slot(sp - 1);
    } else {                      // unknown opcode: the reference's else arm
      op = OP_ELSE;
      pw = clamp_slot(sp - 2);
      sp -= 1;
    }
    code[len] = pack(op, pa, pb, pw, where);
    opr[len] = operands[i];
    ++len;
  }
  *final = clamp_slot(sp - 1);
  return len;
}

// Runs a decoded program on N rows at once: one decoded word and one
// branch on its opcode serve all N rows, and their N column reads are
// issued together; fetch(j, where) gives row j's value of the compared
// column. bit[j] is row j's result.
#define PS_EACH(expr)                  \
  for (int j = 0; j < N; ++j) v[j] = (expr)
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <int N, typename Fetch>
PS_HD void eval_program(const uint32_t* code, const float* opr, int len,
                        int final, Fetch fetch, uint32_t (&bit)[N]) {
  uint32_t stack[N];
  for (int j = 0; j < N; ++j) stack[j] = 0u;
  for (int i = 0; i < len; ++i) {
    const uint32_t w = code[i];
    const int op = w & 15u;
    const uint32_t pa = (w >> 4) & 7u, pb = (w >> 7) & 7u;
    const uint32_t pw = (w >> 10) & 7u;
    uint32_t v[N];
    if (op < 6) {
      float x[N];
      for (int j = 0; j < N; ++j) x[j] = fetch(j, static_cast<int>(w >> 13));
      const float t = opr[i];
      switch (op) {
        case OP_EQ: PS_EACH(x[j] == t); break;
        case OP_NE: PS_EACH(x[j] != t); break;
        case OP_GT: PS_EACH(x[j] > t); break;
        case OP_GE: PS_EACH(x[j] >= t); break;
        case OP_LT: PS_EACH(x[j] < t); break;
        default:    PS_EACH(x[j] <= t); break;
      }
    } else if (op == OP_AND) {
      PS_EACH((stack[j] >> pa) & (stack[j] >> pb) & 1u);
    } else if (op == OP_OR) {
      PS_EACH(((stack[j] >> pa) | (stack[j] >> pb)) & 1u);
    } else {                      // NOT and the else arm
      PS_EACH(((stack[j] >> pa) & 1u) ^ 1u);
    }
    for (int j = 0; j < N; ++j)
      stack[j] = (stack[j] & ~(1u << pw)) | (v[j] << pw);
  }
  for (int j = 0; j < N; ++j) bit[j] = (stack[j] >> final) & 1u;
}
#undef PS_EACH

// Size-profile bucket: clip(sum(size >= edge) - 1, 0, 9) over the f32
// edges 0, 1, 32, 32^2, ..., 32^8 (2^40). Below 1 (and NaN) that is 0;
// from 1 on, size >= 2^(5k) exactly when the binary exponent of size is
// at least 5k, so the bucket is 1 + min(exponent / 5, 8) (infinity: 9).
PS_HD int size_bucket(float size) {
  if (!(size >= 1.0f)) return 0;
  uint32_t u;
#ifdef __CUDA_ARCH__
  u = __float_as_uint(size);
#else
  memcpy(&u, &size, sizeof u);
#endif
  const int e = static_cast<int>(u >> 23) - 127;
  return 1 + (e / 5 < N_BUCKETS - 2 ? e / 5 : N_BUCKETS - 2);
}

}  // namespace policy_scan
